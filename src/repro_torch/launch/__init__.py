"""Launchers of the port (counterpart of ``repro.launch``): the serving
launcher, ``python -m repro_torch.launch.serve``.  The mesh, dry-run and
training launchers are not ported yet."""
