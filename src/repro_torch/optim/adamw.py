"""AdamW with decoupled weight decay, global-norm clipping and LR schedules.

Mirrors `repro/optim/adamw.py`, on the same state layout: a dict
{"m", "v", "count"} whose m and v mirror the param tree and whose count is
an int32 scalar tensor.  Leaves are visited in the reference's
`jax.tree.flatten` order (dict keys sorted; `repro_torch.tree`), so the
global norm sums them in its order.

`update` writes the params, m, v and count in place and returns the same
tensors: the counterpart of the reference driver donating its state to the
jitted step.  A functional update would hold a second copy of params, m
and v, which at full width does not fit the card beside the first.

Under a mesh the leaves are DTensors (a rank holds its slice of each):
the update is elementwise, so each rank updates its local slices, the
same arithmetic as on one device.  The clipping norm is the global norm:
each leaf's local sum of squares, all-reduced over the mesh dims that
shard it (not over those that replicate it, which would count it twice).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_mod
from repro_torch.sharding import partition


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor), as an
    fp32 scalar tensor on the step's device, computed in fp32 as the
    reference's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - frac)
    else:
        decay = torch.ones((), dtype=torch.float32, device=step.device)
    return cfg.lr * warm * decay


_NO_DECAY = ("norm", "bias", "b_", "bq", "bv", "bo", "ln", "a_log", "d_skip")


def _decay_mask(params) -> list[bool]:
    """True where weight decay applies: 2D+ matrices, not norms/biases.

    The reference matches the substrings against `str(path[-1]).lower()`
    of a jax DictKey, which reads "['wq']", brackets and quotes included;
    the name is built the same way here.  Stacked norm scales are 2-D, so
    the name rule, not the rank, excludes them."""
    mask = []
    for path, leaf in tree_mod.leaves_with_paths(params):
        name = f"[{path[-1]!r}]".lower()
        is_norm_or_bias = any(t in name for t in _NO_DECAY)
        mask.append(leaf.dim() >= 2 and not is_norm_or_bias)
    return mask


def init(params) -> dict:
    """Zero m and v beside each param, and count 0 (int32), on the params'
    device."""
    leaves = tree_mod.leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_mod.tree_map(torch.zeros_like, params),
            "v": tree_mod.tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves added
    one after another in the reference's order; a DTensor leaf's local
    sum all-reduced over the mesh axes that split it."""
    total = 0
    for g in tree_mod.leaves(tree):
        sq = partition.local(g).float().square().sum()
        if isinstance(g, DTensor):
            sq = partition.all_reduce(sq, g.device_mesh,
                                      partition.split_axes(g))
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step, in place.  Returns (params, opt_state, metrics): the
    same param, m, v and count tensors, updated, and {"grad_norm", "lr"}.
    The grads are read, never written.  DTensor leaves update their local
    slices."""
    count = partition.local(opt_state["count"])
    count.add_(1)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    mask = _decay_mask(params)
    flat = zip(*(map(partition.local, tree_mod.leaves(t)) for t in (
        grads, params, opt_state["m"], opt_state["v"])), mask)
    for g, p, m, v, wd in flat:
        # fp32 working copies; for fp32 leaves these are the leaves
        # themselves, so the update lands in place
        pf, mf, vf = p.float(), m.float(), v.float()
        gs = g.float() * scale
        mf.mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
        vf.mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
        denom = torch.div(vf, b2c, out=gs).sqrt_().add_(cfg.eps)
        upd = (mf / b1c).div_(denom)
        if wd:
            upd.add_(pf, alpha=cfg.weight_decay)
        pf.sub_(upd.mul_(lr))
        for dst, src in ((p, pf), (m, mf), (v, vf)):
            if src is not dst:
                dst.copy_(src)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
