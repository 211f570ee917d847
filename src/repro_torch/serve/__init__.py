"""Serving: packing and generation (counterpart of ``repro.serve``)."""
