"""Launchers of the port (counterpart of ``repro.launch``): the serving
launcher, ``python -m repro_torch.launch.serve``, and the training
launcher, ``python -m repro_torch.launch.train``.  ``launch.mesh`` builds
meshes of ranks and starts them; the dry-run launchers are not ported
yet."""
