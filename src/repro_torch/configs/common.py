"""Shared helpers for per-architecture configs.

Mirrors `repro/configs/common.py`, with torch dtypes for jnp's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.api import ModelConfig, ShapeCell


def apply_cell_policy(cfg: ModelConfig, cell: ShapeCell,
                      production: bool = True) -> ModelConfig:
    """Specialise a config for a shape cell (training vs serving policies)."""
    updates: dict = {}
    if cell.seq_len > 2048 and cell.kind in ("train", "prefill"):
        # q-block-chunked attention: never materialise [S, S] scores
        updates["attn_chunk"] = 1024
    if cell.kind == "train":
        # remat="full": keep only layer boundaries; "dots" would keep
        # every projection output
        updates.update(remat="full", loss_chunk=1024 if cell.seq_len >= 4096
                       else 0, param_dtype=torch.float32)
        if cfg.moe is not None and production:
            updates["moe"] = dataclasses.replace(
                cfg.moe, impl="ep", fsdp_experts=True)
    else:
        updates.update(param_dtype=torch.bfloat16, remat="none",
                       loss_chunk=0)
        if cfg.moe is not None and production:
            updates["moe"] = dataclasses.replace(
                cfg.moe, impl="ep", fsdp_experts=False)
    if cfg.family == "encdec":
        updates["max_pos"] = max(cfg.max_pos, cell.seq_len + 1)
    return dataclasses.replace(cfg, **updates)
