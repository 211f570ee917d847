"""Sharding of the port's serving and training state over a
``launch.mesh.Mesh`` (counterpart of ``repro.sharding``)."""
from .partition import (ShardingConfig, make_cache_specs, make_data_specs,
                        make_param_specs, place_params)

__all__ = ["ShardingConfig", "make_param_specs", "make_cache_specs",
           "make_data_specs", "place_params"]
