"""Architecture config registry (the dense, SSM, MoE and hybrid families
of the reference's ten).

Usage:
    from repro_torch import configs
    cfg = configs.get("llama3.2-3b")                 # full config
    cfg = configs.get("llama3.2-3b", reduced=True)   # smoke-test config
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "granite-3-8b",
    "yi-9b",
    "qwen3-14b",
    "llama3.2-3b",
    "whisper-large-v3",
    "qwen3-moe-30b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "mamba2-780m",
    "phi-3-vision-4.2b",
    "jamba-v0.1-52b",
]

_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

# arch id -> the ROADMAP item that ports its family
_NOT_PORTED = {
    "whisper-large-v3": "A11 (encoder-decoder)",
    "phi-3-vision-4.2b": "A11 (VLM)",
}


def get(arch_id: str, reduced: bool = False):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: ROADMAP {_NOT_PORTED[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG
