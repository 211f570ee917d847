"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch the layers call (counterpart of ``repro.kernels``)."""
