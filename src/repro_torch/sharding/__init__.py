"""Sharding of the port's serving state over a ``launch.mesh.Mesh``
(counterpart of ``repro.sharding``)."""
