"""Inputs per (config, shape cell); mirrors `repro/models/io.py`.

`input_specs` gives `meta` tensors (shapes and dtypes, never allocated),
`make_batch` concrete tensors, and `input_axis_specs` the matching
logical-axes tree from which the placements derive.
"""
from __future__ import annotations

import torch

from repro_torch.models import stack
from repro_torch.models.api import ModelConfig, ShapeCell


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_inputs(cfg: ModelConfig, b: int, s: int) -> dict:
    specs = {"tokens": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "vlm":
        specs["patches"] = _meta((b, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
    return specs


def _batch_axes_tree(cfg: ModelConfig) -> dict:
    axes = {"tokens": ("batch", None)}
    if cfg.family == "encdec":
        axes["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        axes["patches"] = ("batch", None, None)
    return axes


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract inputs of the cell's step function.

    train/prefill: {"batch": {...}}
    decode:        {"cache": ..., "tokens": [B,1], "pos": scalar}
    """
    if cell.kind in ("train", "prefill"):
        return {"batch": _batch_inputs(cfg, cell.global_batch, cell.seq_len)}
    return {
        "cache": stack.abstract_cache(cfg, cell.global_batch, cell.seq_len),
        "tokens": _meta((cell.global_batch, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }


def input_axis_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.kind in ("train", "prefill"):
        return {"batch": _batch_axes_tree(cfg)}
    return {
        "cache": stack.cache_axis_specs(cfg),
        "tokens": ("batch", None),
        "pos": (),
    }


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
