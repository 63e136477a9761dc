"""Concrete inputs per (config, shape cell); mirrors `repro/models/io.py`."""
from __future__ import annotations

import torch

from repro_torch.models.api import ModelConfig, ShapeCell


def make_batch(cfg: ModelConfig, cell: ShapeCell,
               generator: torch.Generator) -> dict:
    """{"tokens": [B, S] int32} on `generator.device`, uniform over the
    logical vocabulary; the encoder-decoder adds stub audio frames
    ("frames" [B, enc_seq, D]) and the VLM stub image patches ("patches"
    [B, n_patches, D]), both bf16 and drawn as normal x 0.02, as the
    reference's."""
    b, s = cell.global_batch, cell.seq_len
    dev = generator.device
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s),
                                     generator=generator, device=dev,
                                     dtype=torch.int32)}
    stub = {"encdec": ("frames", cfg.enc_seq),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub is not None:
        name, n = stub
        x = torch.randn((b, n, cfg.d_model), generator=generator, device=dev)
        batch[name] = x.mul_(0.02).to(torch.bfloat16)
    return batch


def smoke_cell(kind: str, b: int = 2, s: int = 32) -> ShapeCell:
    return ShapeCell(f"smoke_{kind}", s, b, kind)
