"""Architecture config registry: the reference's ten architectures
(`ARCH_IDS`), and those the port serves besides them (`PORT_ARCH_IDS`).

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

# every architecture the port serves: the reference's ten and those with a
# plain reference of their own (`src/plain_ref/`) in their place
PORT_ARCH_IDS = ARCH_IDS + ["nemotron-3-nano-30b-a3b", "trinity-mini"]

_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-780m": "mamba2_780m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-large-v3": "whisper_large_v3",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "nemotron-3-nano-30b-a3b": "nemotron_3_nano_30b_a3b",
    "trinity-mini": "trinity_mini",
}


def get(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG
