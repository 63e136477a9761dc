"""Mixture-of-Experts FFN, single device.

Mirrors `repro/models/moe.py`.  Two routes with identical math:

- ``dense`` (`moe_dense`): GShard-style one-hot dispatch and combine
  einsums over [T, E, C].  Shape-static and simple: the plain oracle.
- ``ep`` (`moe_ep`): the reference's expert-parallel body on a mesh of one
  device.  Every expert is local, so dispatch is a gather of the tokens
  each (expert, slot) holds, the expert outputs are weighted and combined
  by `index_add_` into [T, D], and the reference's psum over the expert
  axis (one device) is the identity.  Each (expert, slot) holds at most
  one token, so it computes `moe_dense`'s function without its [T, E, C]
  products.  The sharded form over several GPUs waits for ROADMAP A13.

Routing: softmax top-k with normalised combine weights and a Switch-style
load-balancing aux loss, capacity-limited with token dropping.  Ties in
the top-k go to the lower expert index, as `jax.lax.top_k` breaks them,
and drops follow the queue position in token-major (token, k) order; both
routes keep that order through stable sorts.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden width
    capacity_factor: float = 1.25
    impl: str = "dense"         # "dense" | "ep"


def router_probs(params, x: torch.Tensor, spec: MoESpec):
    """x: [T, D] -> (top-k probs [T,K], top-k idx [T,K], aux_loss scalar)."""
    logits = x.float() @ params["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, as jax.lax.top_k does (torch.topk promises no order)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :spec.top_k], top_i[:, :spec.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch/GShard load-balance loss: E * sum_e f_e * p_e
    pe = probs.mean(dim=0)                                     # [E]
    fe = F.one_hot(top_i, spec.n_experts).sum(dim=1).float().mean(dim=0)
    aux = spec.n_experts * (pe * fe).sum()
    return top_p, top_i, aux


def _expert_ffn(w1, w3, w2, x):
    """Batched per-expert SwiGLU: x [E, C, D]; w1/w3 [E, D, F]; w2 [E, F, D]."""
    gate = torch.bmm(x, w1.to(x.dtype))
    up = torch.bmm(x, w3.to(x.dtype))
    h = F.silu(gate.float()).to(x.dtype) * up
    return torch.bmm(h, w2.to(x.dtype))


def _capacity(n_tokens: int, spec: MoESpec) -> int:
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(8, ((c + 7) // 8) * 8)  # at least 8, a multiple of 8


# ---------------------------------------------------------------------------
# dense (one-hot) oracle
# ---------------------------------------------------------------------------


def _dense_dispatch(top_p, top_i, cap: int, spec: MoESpec, dtype):
    """The one-hot dispatch and combine tensors [T, E, C]: token t fills
    slot c of expert e when e is among its top k and its queue position
    (a cumsum over (token, k) in token-major order) is below `cap`."""
    t, k = top_i.shape
    e = spec.n_experts
    onehot = F.one_hot(top_i, e)                                # [T,K,E]
    flat = onehot.reshape(t * k, e)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(t, k, e)
    within = (pos >= 0) & (pos < cap)
    disp = torch.zeros((t, e, cap), dtype=dtype, device=top_i.device)
    idx_t = torch.arange(t, device=top_i.device)[:, None, None].expand(t, k, e)
    idx_e = torch.arange(e, device=top_i.device)[None, None, :].expand(t, k, e)
    disp.index_put_((idx_t, idx_e, pos.clamp(0, cap - 1)),
                    within.to(dtype), accumulate=True)
    combine = disp * torch.einsum("tk,tke->te", top_p.to(dtype),
                                  onehot.to(dtype))[:, :, None]
    return disp, combine


def moe_dense(params, x: torch.Tensor, spec: MoESpec):
    """x: [B, S, D] -> (y, aux). One-hot dispatch; exact capacity semantics."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_p, top_i, aux = router_probs(params, xt, spec)
    cap = _capacity(b * s, spec)
    disp, combine = _dense_dispatch(top_p, top_i, cap, spec, x.dtype)
    xe = torch.einsum("tec,td->ecd", disp, xt)                 # [E, C, D]
    ye = _expert_ffn(params["w1"], params["w3"], params["w2"], xe)
    yt = torch.einsum("tec,ecd->td", combine, ye)
    return yt.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel route on one device: gather, experts, index_add_
# ---------------------------------------------------------------------------


def _sorted_dispatch(xt, top_p, top_i, cap: int, spec: MoESpec):
    """Gather each expert's tokens into its `cap` slots.

    xt: [T, D].  Returns (xe [E, C, D], src_idx [E, C], weight [E, C])
    where src_idx rows index into xt (0 and weight 0 where a slot is
    empty).  The reference's `_sorted_dispatch_local` with every expert
    local (e_lo = 0, e_loc = E).  The stable sort by expert id keeps each
    expert's queue in token-major (token, k) order, so the pairs past
    `cap` are those `moe_dense` drops.
    """
    t, e = xt.shape[0], spec.n_experts
    dev = xt.device
    key = top_i.reshape(-1)                                    # [T*K]
    src = torch.arange(t, device=dev).repeat_interleave(spec.top_k)
    order = torch.argsort(key, stable=True)
    key_s, src_s, p_s = key[order], src[order], top_p.reshape(-1)[order]
    # rank within the expert's group: distance from the group's first entry
    rank = (torch.arange(key_s.numel(), device=dev)
            - torch.searchsorted(key_s, key_s))
    within = rank < cap
    slot = torch.where(within, key_s * cap + rank.clamp(max=cap - 1), e * cap)
    src_idx = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    weight = torch.zeros(e * cap + 1, dtype=torch.float32, device=dev)
    src_idx[slot] = torch.where(within, src_s, 0)
    weight.index_add_(0, slot, torch.where(within, p_s.float(), 0.0))
    src_idx = src_idx[:-1].reshape(e, cap)
    weight = weight[:-1].reshape(e, cap)
    xe = xt[src_idx.reshape(-1)].reshape(e, cap, -1)
    xe = xe * (weight[..., None] > 0).to(xe.dtype)
    return xe, src_idx, weight


def moe_ep(params, x: torch.Tensor, spec: MoESpec):
    """x: [B, S, D] -> (y, aux): the reference's expert-parallel body with
    every expert on this device."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_i, aux = router_probs(params, xt, spec)
    cap = _capacity(t, spec)
    xe, src_idx, weight = _sorted_dispatch(xt, top_p, top_i, cap, spec)
    ye = _expert_ffn(params["w1"], params["w3"], params["w2"], xe)
    ye = ye * weight[..., None].to(ye.dtype)
    yt = torch.zeros((t, d), dtype=ye.dtype, device=x.device)
    yt.index_add_(0, src_idx.reshape(-1), ye.reshape(-1, d))
    return yt.reshape(b, s, d), aux


def moe_ffn(params, x, spec: MoESpec):
    """The route `spec.impl` names: "dense" the oracle, "ep" the gather."""
    if spec.impl == "dense":
        return moe_dense(params, x, spec)
    if spec.impl == "ep":
        return moe_ep(params, x, spec)
    raise ValueError(f"unknown moe impl {spec.impl!r}")
