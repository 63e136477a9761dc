"""Concrete inputs per (config, shape cell); mirrors `repro/models/io.py`."""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.api import ModelConfig, ShapeCell


def make_batch(cfg: ModelConfig, cell: ShapeCell,
               generator: torch.Generator) -> dict:
    """{"tokens": [B, S] int32} on `generator.device`, uniform over the
    logical vocabulary (the dense, SSM, MoE and hybrid families take tokens
    only)."""
    api.require_ported(cfg)
    tokens = torch.randint(0, cfg.vocab, (cell.global_batch, cell.seq_len),
                           generator=generator, device=generator.device,
                           dtype=torch.int32)
    return {"tokens": tokens}


def smoke_cell(kind: str, b: int = 2, s: int = 32) -> ShapeCell:
    return ShapeCell(f"smoke_{kind}", s, b, kind)
