"""Architecture registry of the port: the paper's Llama-3.2 pair and
DeepSeek-V2-Lite (MLA + MoE).

``get_config(arch_id)`` returns the registered ArchEntry with the published
hyperparameters (``full``) and a reduced same-family ``smoke`` config.
The other architectures of ``repro.configs`` are not ported yet.
"""
from .base import ArchEntry, get, all_archs

# Import for registration side effects.
from . import deepseek_v2_lite_16b, llama32_paper

PAPER_ARCHS = ["llama3.2-1b", "llama3.2-3b"]


def get_config(arch_id: str) -> ArchEntry:
    return get(arch_id)


__all__ = ["ArchEntry", "get_config", "all_archs", "PAPER_ARCHS"]
