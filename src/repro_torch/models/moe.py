"""Mixture-of-Experts FFN.

Mirrors `repro/models/moe.py`.  Two routes with identical math:

- ``dense`` (`moe_dense`): GShard-style one-hot dispatch and combine
  einsums over [T, E, C].  Shape-static and simple: the plain oracle.
- ``ep`` (`moe_ep`): the reference's expert-parallel body.  Dispatch is a
  gather of the tokens each local (expert, slot) holds, the expert outputs
  are weighted and combined by `index_add_` into [T, D], and the combine
  is summed over the expert-parallel ranks.  Each (expert, slot) holds at
  most one token, so it computes `moe_dense`'s function without its
  [T, E, C] products.  Without a mesh every expert is local (the
  reference's body on one device).  Under a mesh the experts are split
  over the `ep_axis` ranks: rank j holds experts [j * E_loc, (j+1) * E_loc)
  (`ep_placements` says how the stack gathers them: the expert dim stays
  sharded, a ZeRO-3 `fsdp_experts` dim is all-gathered), the tokens of
  the rank's batch shard are the same on every rank of the ep axis, and
  the combine is `all_reduce`d over it (Megatron's pair: the gradient of
  the shared inputs is summed over the ep ranks, the combine's is not).

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
from torch.distributed.tensor import Replicate, Shard

from repro_torch.sharding import partition


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden width
    capacity_factor: float = 1.25
    impl: str = "dense"         # "dense" | "ep"
    fsdp_experts: bool = False  # ZeRO-3 gather of expert weights over "data"
    ep_axis: str = "model"
    fsdp_axis: str = "data"


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
# the expert-parallel route: gather, experts, index_add_, the ep sum
# ---------------------------------------------------------------------------


def _sorted_dispatch(xt, top_p, top_i, cap: int, spec: MoESpec,
                     e_lo: int = 0, e_loc: int | None = None):
    """Gather the tokens of the local experts [e_lo, e_lo + e_loc) into
    their `cap` slots (default: every expert).

    xt: [T, D].  Returns (xe [E_loc, C, D], src_idx [E_loc, C], weight
    [E_loc, C]) where src_idx rows index into xt (0 and weight 0 where a
    slot is empty).  The reference's `_sorted_dispatch_local`.  The
    stable sort by expert id (non-local pairs pushed to the end) keeps
    each expert's queue in token-major (token, k) order, so the pairs
    past `cap` are those `moe_dense` drops.
    """
    t = xt.shape[0]
    e_loc = spec.n_experts if e_loc is None else e_loc
    dev = xt.device
    flat_i = top_i.reshape(-1)                                 # [T*K]
    src = torch.arange(t, device=dev).repeat_interleave(spec.top_k)
    local = (flat_i >= e_lo) & (flat_i < e_lo + e_loc)
    key = torch.where(local, flat_i - e_lo, e_loc)
    order = torch.argsort(key, stable=True)
    key_s, src_s, p_s = key[order], src[order], top_p.reshape(-1)[order]
    # rank within the expert's group: distance from the group's first entry
    rank = (torch.arange(key_s.numel(), device=dev)
            - torch.searchsorted(key_s, key_s))
    within = (key_s < e_loc) & (rank < cap)
    slot = torch.where(within, key_s * cap + rank.clamp(max=cap - 1),
                       e_loc * cap)
    src_idx = torch.zeros(e_loc * cap + 1, dtype=torch.long, device=dev)
    weight = torch.zeros(e_loc * cap + 1, dtype=torch.float32, device=dev)
    src_idx[slot] = torch.where(within, src_s, 0)
    weight.index_add_(0, slot, torch.where(within, p_s.float(), 0.0))
    src_idx = src_idx[:-1].reshape(e_loc, cap)
    weight = weight[:-1].reshape(e_loc, cap)
    xe = xt[src_idx.reshape(-1)].reshape(e_loc, cap, -1)
    xe = xe * (weight[..., None] > 0).to(xe.dtype)
    return xe, src_idx, weight


def ep_placements(placements, mesh, spec: MoESpec, expert_dim: int) -> list:
    """What a rank computes with for an expert weight held at
    `placements`: the expert dim sharded over `ep_axis`, every other mesh
    dim (the `fsdp_experts` one included) all-gathered."""
    names = list(mesh.mesh_dim_names)
    return [Shard(expert_dim) if names[i] == spec.ep_axis else Replicate()
            for i in range(len(placements))]


def moe_ep(params, x: torch.Tensor, spec: MoESpec, mesh=None,
           batch_axes=("data",)):
    """x: [B, S, D] -> (y, aux): the reference's expert-parallel body.

    Without a mesh every expert is on this device.  Under a mesh, x is
    this rank's batch shard (the same on every rank of `ep_axis`) and
    w1/w3/w2 hold this rank's E / n_ep experts ([E_loc, D, F] / [E_loc,
    F, D], gathered by `ep_placements`); the combine is summed over the ep
    ranks and aux, the router's load-balance loss over the local tokens,
    is averaged over the batch ranks (the ep ranks' values are equal, so
    this is the reference's mean over both)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    top_p, top_i, aux = router_probs(params, xt, spec)
    cap = _capacity(t, spec)
    if mesh is None:
        xe, src_idx, weight = _sorted_dispatch(xt, top_p, top_i, cap, spec)
    else:
        ep = spec.ep_axis
        if ep in partition.flat_axes(batch_axes):
            raise ValueError(f"the expert axis {ep!r} also shards the "
                             f"batch {batch_axes}")
        n_ep = partition.axis_size(mesh, ep)
        assert spec.n_experts % n_ep == 0, (spec.n_experts, n_ep)
        e_loc = spec.n_experts // n_ep
        assert params["w1"].shape[0] == e_loc, (params["w1"].shape, e_loc)
        e_lo = partition.axis_index(mesh, ep) * e_loc
        xe, src_idx, weight = _sorted_dispatch(
            partition.copy_to_group(xt, mesh, ep),
            partition.copy_to_group(top_p, mesh, ep), top_i, cap, spec,
            e_lo, e_loc)
    ye = _expert_ffn(params["w1"], params["w3"], params["w2"], xe)
    ye = ye * weight[..., None].to(ye.dtype)
    yt = torch.zeros((t, d), dtype=ye.dtype, device=x.device)
    yt.index_add_(0, src_idx.reshape(-1), ye.reshape(-1, d))
    if mesh is not None:
        yt = partition.reduce_from_group(yt, mesh, spec.ep_axis)
        n_b = partition.axis_size(mesh, batch_axes)
        aux = partition.reduce_from_group(aux, mesh, batch_axes) / n_b
    return yt.reshape(b, s, d), aux


def moe_ffn(params, x, spec: MoESpec, mesh=None, batch_axes=("data",)):
    """The route `spec.impl` names: "dense" the oracle, "ep" the gather
    (on one device) or the expert-parallel body (under a mesh).  Under a
    mesh each rank holds only its batch shard, so the oracle, whose
    capacity and queues span the global batch, does not run there."""
    if spec.impl == "dense":
        if mesh is not None:
            raise ValueError("under a mesh the MoE runs impl='ep' "
                             "(the oracle's queues span the global batch)")
        return moe_dense(params, x, spec)
    if spec.impl == "ep":
        return moe_ep(params, x, spec, mesh, batch_axes)
    raise ValueError(f"unknown moe impl {spec.impl!r}")
