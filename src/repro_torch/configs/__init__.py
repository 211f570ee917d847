"""Architecture registry of the port: the reference's archs and the
paper's Llama-3.2 pair.

``get_config(arch_id)`` returns the registered ArchEntry with the published
hyperparameters (``full``) and a reduced same-family ``smoke`` config, as
``repro.configs`` registers them: dense (Llama, Qwen2's QKV bias, Qwen3's
qk-norm, InternLM2, Llama-3-405B), MoE (DeepSeek-V2-Lite's MLA, Kimi-K2's
GQA), ``ssm`` (Mamba2), ``hybrid`` (Zamba2), ``vlm`` (InternVL2) and
``encdec`` (seamless-m4t-medium, ``models/encdec.py``).
"""
from .base import ArchEntry, get, all_archs

# Import for registration side effects.
from . import (mamba2_2_7b, qwen3_4b, llama3_405b, internlm2_1_8b, qwen2_7b,
               deepseek_v2_lite_16b, kimi_k2_1t_a32b, internvl2_2b,
               zamba2_1_2b, seamless_m4t_medium, llama32_paper)

PAPER_ARCHS = ["llama3.2-1b", "llama3.2-3b"]


def get_config(arch_id: str) -> ArchEntry:
    return get(arch_id)


__all__ = ["ArchEntry", "get_config", "all_archs", "PAPER_ARCHS"]
