"""Sharding of the port's serving and training state over a
``launch.mesh.Mesh`` (counterpart of ``repro.sharding``)."""
