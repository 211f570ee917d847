"""Tiny-QMoE in PyTorch and CUDA — the port of the JAX package ``repro``.

Same layout as ``repro`` (``core/``, ``kernels/``, ``models/``,
``configs/``, ``serve/``); imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where every kernel takes its plain PyTorch version.
"""
