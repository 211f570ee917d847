"""Quantization, the gram dictionary, the blocked codec and the weight
containers (counterpart of ``repro.core``)."""
