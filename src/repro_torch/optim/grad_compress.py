"""Gradient compression for slow (inter-node) links: int8 + error feedback.

Mirrors `repro/optim/grad_compress.py`.  Per-row (last-axis) absmax int8
quantisation.  Error feedback keeps the quantisation residual locally and
adds it to the next step's gradient, so the compression bias vanishes over
steps (the EF-SGD convergence argument applies).

On one device the train step models compress + all-reduce as a quantise /
dequantise round trip on every gradient leaf, before the optimizer:

    grads, ef = compress_grads(grads, ef_state)

`torch.round` rounds half to even, as `jnp.round` does, and every other
step is one IEEE operation in fp32, so `quantize_int8` gives the
reference's bits on the same fp32 input, on the CPU and on the card.

Under a mesh the gradient and error-feedback leaves are DTensors: the
round trip and the error feedback run on each rank's local slice, and a
row's absmax is all-reduced (MAX) over the mesh axes that split the last
dim, so every rank scales a row as the whole row is scaled: the same bits
as on one device, at any number of ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_mod
from repro_torch.sharding import partition


def quantize_int8(x: torch.Tensor, mesh=None,
                  row_axes=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (q [int8], scale [.., 1] f32) along the last axis.  With a
    mesh, x is a local slice whose rows continue on the ranks of
    `row_axes`: the absmax is taken over the whole row."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    if mesh is not None:
        absmax = partition.all_reduce(absmax, mesh, row_axes,
                                      dist.ReduceOp.MAX)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is an ulp off IEEE division
    # (the reference's, and the CPU's) for ~5% of inputs
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _skipped(g: torch.Tensor) -> bool:
    """Scalars and leaves under 256 elements travel uncompressed."""
    return g.dim() < 1 or g.numel() < 256


def init_error_feedback(grads):
    return tree_mod.tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def compress_grads(grads, ef_state):
    """Error-feedback int8 round trip on every gradient leaf.

    Returns (compressed_grads, new_ef_state), new trees."""
    def local_leaf(g, e, skip, mesh=None, row_axes=()):
        gf = g.float() + e
        if skip:
            return gf.to(g.dtype), torch.zeros_like(e)
        q, s = quantize_int8(gf, mesh, row_axes)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    def leaf(g, e):
        if not isinstance(g, DTensor):
            return local_leaf(g, e, _skipped(g))
        out = local_leaf(g.to_local(), e.to_local(), _skipped(g),
                         g.device_mesh, partition.split_axes(g, g.dim() - 1))
        return tuple(DTensor.from_local(t, g.device_mesh, g.placements,
                                        shape=g.shape, stride=g.stride())
                     for t in out)

    pairs = tree_mod.tree_map(leaf, grads, ef_state)
    return (tree_mod.tree_map(lambda p: p[0], pairs),
            tree_mod.tree_map(lambda p: p[1], pairs))


def compression_ratio(grads) -> float:
    """Bytes on the wire: int8 payload + f32 row scales vs f32."""
    total = 0
    compressed = 0
    for g in tree_mod.leaves(grads):
        n = g.numel()
        total += n * 4
        if _skipped(g):
            compressed += n * 4
        else:
            rows = n // g.shape[-1]
            compressed += n * 1 + rows * 4
    return compressed / total
