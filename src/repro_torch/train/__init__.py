"""Training runtime of the port (counterpart of ``repro.train``).  Only
the data pipeline is ported so far, for the serving launcher's prompts;
the optimizer, steps, checkpoint and fault tolerance wait for the training
slice."""
from .data import DataConfig, DataPipeline

__all__ = ["DataConfig", "DataPipeline"]
