"""Training runtime of the port (counterpart of ``repro.train``): the data
pipeline, AdamW (int8 moments optional), the train step (on one device or
a mesh of ranks), checkpoints and the fault-tolerant loop, and a briefly
trained smoke model."""
from . import checkpoint, fault
from .data import DataConfig, DataPipeline
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule
from .steps import (TrainConfig, cross_entropy, init_train_state,
                    make_train_step)
from .trained import trained_tiny_model

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "TrainConfig", "make_train_step", "init_train_state",
           "cross_entropy", "DataConfig", "DataPipeline", "checkpoint",
           "fault", "trained_tiny_model"]
