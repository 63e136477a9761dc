"""Layout adaptors — the bus-virtualisation analogue (paper section 4.1.2).

Mirrors `repro/core/bus.py`.  A module's interface fixes shapes and
dtypes.  When a caller's arrays differ (dtype, batch padding, host
layout), an adaptor is instantiated *only for that module* (the paper's
"adaptor integrated into a module only if needed") translating caller
data to the slot's expected form and back, and accounting the bytes it
moves (Table-2 analogue).  Adaptation happens where the caller's data
lies (the host, for numpy inputs); `run_placement` moves the result to
the slot.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.module import TensorSpec, tree_map


@dataclasses.dataclass
class AdaptorReport:
    casts: int = 0
    pads: int = 0
    bytes_moved: int = 0
    identity: bool = True


def _leaf_bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _flatten(tree) -> tuple[list, Callable]:
    """(leaves, rebuild) of nested dicts, lists and tuples, walked as the
    reference's pytree flatten walks them: dict entries in sorted-key
    order, None a node without leaves.  `rebuild(leaves)` puts new leaves
    back into the same structure."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        parts = [_flatten(tree[k]) for k in keys]
        sizes = [len(leaves) for leaves, _ in parts]

        def rebuild(leaves):
            kids, i = [], 0
            for (_, build), n in zip(parts, sizes):
                kids.append(build(leaves[i:i + n]))
                i += n
            if isinstance(tree, dict):
                return dict(zip(keys, kids))
            return type(tree)(kids)
        return [leaf for leaves, _ in parts for leaf in leaves], rebuild
    return [tree], lambda leaves: leaves[0]


def _adapt_leaf(g, w: TensorSpec, rep: AdaptorReport) -> torch.Tensor:
    g = torch.as_tensor(np.asarray(g) if not torch.is_tensor(g) else g)
    if g.dtype != w.dtype:
        g = g.to(w.dtype)
        rep.casts += 1
        rep.identity = False
        rep.bytes_moved += _leaf_bytes(g)
    if tuple(g.shape) != tuple(w.shape):
        assert g.dim() == len(w.shape), (tuple(g.shape), w.shape)
        assert all(gs <= ws for gs, ws in zip(g.shape, w.shape)), \
            f"input {tuple(g.shape)} exceeds module interface {w.shape}"
        padded = g.new_zeros(w.shape)
        padded[tuple(slice(0, gs) for gs in g.shape)] = g
        g = padded
        rep.pads += 1
        rep.identity = False
        rep.bytes_moved += _leaf_bytes(g)
    return g


def adapt_inputs(args: tuple, abstract_inputs: tuple
                 ) -> tuple[tuple, AdaptorReport]:
    """Coerce caller args (numpy arrays or tensors, or nested dicts, lists
    and tuples of them) to the module's abstract input signature (the same
    structures of TensorSpecs), leaf by leaf."""
    rep = AdaptorReport()
    out = []
    for given, want_tree in zip(args, abstract_inputs):
        flat_g, rebuild = _flatten(given)
        flat_w, _ = _flatten(want_tree)
        out.append(rebuild([_adapt_leaf(g, w, rep)
                            for g, w in zip(flat_g, flat_w)]))
    return tuple(out), rep


def strip_outputs(out, orig_batch: int | None):
    """Undo batch padding on the way back (best-effort, dim 0)."""
    if orig_batch is None:
        return out
    return tree_map(
        lambda x: x[:orig_batch] if hasattr(x, "shape") and x.ndim >= 1
        else x, out)
