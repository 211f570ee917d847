"""Model config, layers and the dense LM (counterpart of ``repro.models``)."""
