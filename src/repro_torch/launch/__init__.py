"""Launchers of the port (counterpart of ``repro.launch``): the serving
launcher, ``python -m repro_torch.launch.serve``, the training launcher,
``python -m repro_torch.launch.train``, and the dry run, ``python -m
repro_torch.launch.dryrun`` (``launch.specs``, ``launch.op_stats``).
``launch.mesh`` builds meshes of ranks and starts them, and plans one rank
of any mesh without them (``PlannedMesh``)."""
from .mesh import (PlannedMesh, make_host_mesh, make_mesh,
                   make_production_mesh)

__all__ = ["make_production_mesh", "make_mesh", "make_host_mesh",
           "PlannedMesh"]
