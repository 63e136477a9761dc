"""GPipe-style pipeline parallelism over a mesh axis (default: "pod").

Mirrors `repro/sharding/pipeline_parallel.py`, with the reference's
`shard_map` body written per rank:

  - the model is split into S stages (contiguous layer groups) whose params
    carry a leading stage axis, sharded over `axis` (a DTensor, of which
    each rank holds its stage) or whole on every rank (each takes its own);
  - the global batch is split into M microbatches;
  - at schedule tick t, stage s processes microbatch (t - s); activations
    move to the next stage around the ring of `axis` ranks by
    `batch_isend_irecv` (the reference's `ppermute`);
  - bubbles are masked: an idle stage passes its input on without running
    `stage_fn` (the reference runs it and discards the result); the last
    stage's outputs reach every stage by an all-reduce of outs * is_last
    (the reference's psum).

stage_fn must be shape-preserving on the activation ([b, ...] -> [b, ...]).
Forward only, as the reference's test runs it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding import partition


def _map(fn, tree):
    """fn over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _ring_peers(mesh, axis: str) -> tuple[int, int]:
    """Global ranks of the next and the previous stage on `axis`."""
    d = list(mesh.mesh_dim_names).index(axis)
    coord = list(mesh.get_coordinate())
    n = mesh.size(d)

    def rank_at(i):
        c = list(coord)
        c[d] = i % n
        return int(mesh.mesh[tuple(c)])
    return rank_at(coord[d] + 1), rank_at(coord[d] - 1)


def _ppermute(h: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Send h to the next stage, receive the previous stage's."""
    if partition.axis_size(mesh, axis) == 1:
        return h
    nxt, prev = _ring_peers(mesh, axis)
    group = mesh.get_group(axis)
    h = h.contiguous()
    got = torch.empty_like(h)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h, nxt, group),
        dist.P2POp(dist.irecv, got, prev, group)])
    for r in reqs:
        r.wait()
    return got


def gpipe_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                axis: str = "pod", n_micro: int | None = None):
    """Run S pipeline stages over x: equivalent to sequentially applying
    stage_fn with stage_params[s] for s in range(S).

    stage_params: tree (dicts, lists, tuples) with a leading stage axis
    (size S) on every leaf.
    x: [B, ...] activations, the same on every rank of `axis`.
    Returns [B, ...], the same on every rank of `axis`.
    """
    s_stages = partition.axis_size(mesh, axis)
    sid = partition.axis_index(mesh, axis)
    b = x.shape[0]
    n_micro = n_micro or max(s_stages, 1)
    assert b % n_micro == 0, (b, n_micro)
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    local = _map(
        lambda a: a.to_local()[0] if isinstance(a, DTensor) else a[sid],
        stage_params)
    fifo = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    for t in range(n_micro + s_stages - 1):
        active = 0 <= t - sid < n_micro
        inp = micro[min(t, n_micro - 1)] if sid == 0 else fifo
        h = stage_fn(local, inp) if active else fifo
        if sid == s_stages - 1 and active:
            outs[t - (s_stages - 1)] = h
        fifo = _ppermute(h, mesh, axis)
    # broadcast the last stage's outputs to every stage
    is_last = float(sid == s_stages - 1)
    outs = partition.all_reduce(outs * is_last, mesh, axis)
    return outs.reshape(b, *x.shape[1:])


def split_stages(stacked_params, n_stages: int):
    """[L, ...] layer-stacked params -> [S, L/S, ...] stage-stacked."""
    def f(a):
        n = a.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])
    return _map(f, stacked_params)
