"""Mixture-of-Experts FFN.

Mirrors `repro/models/moe.py`.  Two routes with identical math:

- ``dense`` (`moe_dense`): GShard-style one-hot dispatch and combine
  einsums over [T, E, C].  Shape-static and simple: the plain oracle;
  under a mesh it runs over the batch gathered from the batch ranks
  with every expert (`moe_dense_sharded`).
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
  Each expert's kept pairs fill its slots from the front, so on one
  CUDA device, in fp32, with no gradient to take and at a capacity of at least
  one row tile (a prefill), its products run grouped
  (`kernels/expert_gemm`): only the row tiles that hold an occupied slot
  are computed, with torch.bmm's arithmetic on them.

Routing: softmax top-k with normalised combine weights and a Switch-style
load-balancing aux loss, capacity-limited with token dropping.  Ties in
the top-k go to the lower expert index, as `jax.lax.top_k` breaks them,
and drops follow the queue position in token-major (token, k) order; both
routes keep that order through stable sorts.

nemotron-h's layer (`router="sigmoid_bias"`, `expert_act="relu2"`,
`shared_d_ff`): scores sigmoid(x W) in fp32, the top k of scores +
`router_bias` (the published e_score_correction_bias) chosen, weighted by
their unbiased scores renormalised to sum 1 and times `routed_scale`;
each expert is W2 relu(W1 x)^2; an always-on shared expert of the same
form is added to every token's output.  That router has no aux loss (the
bias balances the load): its aux is 0.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels.expert_gemm import ops as eg_ops
from repro_torch.obs import spans
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
    router: str = "softmax"     # "softmax" | "sigmoid_bias"
    routed_scale: float = 1.0
    expert_act: str = "swiglu"  # "swiglu" | "relu2"
    shared_d_ff: int = 0        # the shared expert's width (0: none)


def _sigmoid_router(params, logits, spec: MoESpec):
    """nemotron-h's choice and weights: top k of sigmoid(logits) + the
    bias, weighted by the chosen unbiased scores, renormalised (the
    published 1e-20 in the denominator) and scaled."""
    scores = torch.sigmoid(logits)
    choice = scores + params["router_bias"].float()
    top_i = torch.sort(choice, dim=-1, descending=True,
                       stable=True).indices[:, :spec.top_k]
    top_p = scores.gather(1, top_i)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-20)
    return (top_p * spec.routed_scale, top_i,
            torch.zeros((), dtype=torch.float32, device=logits.device))


def router_probs(params, x: torch.Tensor, spec: MoESpec):
    """x: [T, D] -> (top-k probs [T,K], top-k idx [T,K], aux_loss scalar)."""
    logits = x.float() @ params["w_router"].float()
    if spec.router == "sigmoid_bias":
        return _sigmoid_router(params, logits, spec)
    if spec.router != "softmax":
        raise ValueError(f"unknown router {spec.router!r}")
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


def _expert_ffn(params, x, spec: MoESpec, counts=None):
    """Batched per-expert FFN: x [E, C, D]; w1 (/w3) [E, D, F]; w2 [E, F,
    D].  SwiGLU, or with `expert_act="relu2"` W2 relu(W1 x)^2.  With
    `counts` ([E] int32: each expert's occupied slots, a prefix of its C)
    each product is `expert_gemm`'s, which computes only the row tiles
    that hold an occupied slot and gives 0 past the count."""
    if counts is None:
        mm = torch.bmm
    else:
        def mm(a, b):
            return eg_ops.expert_gemm(a, b, counts)
    w1, w2 = params["w1"], params["w2"]
    gate = mm(x, w1.to(x.dtype))
    if spec.expert_act == "relu2":
        h = torch.relu(gate).square()
    else:
        up = mm(x, params["w3"].to(x.dtype))
        h = F.silu(gate.float()).to(x.dtype) * up
    return mm(h, w2.to(x.dtype))


# the devices on which `expert_gemm` launches its kernel; on the CPU its
# plain version would do torch.bmm's work and more
_GROUPED_DEVICES = ("cuda",)


def _grouped(params, xe, mesh) -> bool:
    """Whether the expert product runs over the occupied row tiles only
    (`expert_gemm`): on one CUDA device, in fp32, with no gradient to
    take, and at a capacity of at least one row tile (a prefill; a decode
    step's capacity of 8 keeps torch.bmm)."""
    ws = [params[k] for k in ("w1", "w2", "w3") if k in params]
    return (mesh is None and xe.device.type in _GROUPED_DEVICES
            and xe.shape[1] >= eg_ops.ROW_TILE
            and xe.dtype == torch.float32
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (xe, *ws))))


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
    ye = _expert_ffn(params, xe, spec)
    yt = torch.einsum("tec,ecd->td", combine, ye)
    return yt.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel route: gather, experts, index_add_, the ep sum
# ---------------------------------------------------------------------------


def _pairs_past_cap(key_s, rank, e_loc: int, cap: int):
    """The local pairs `_sorted_dispatch` drops: a count for
    `repro_torch.obs.spans`."""
    return torch.count_nonzero((key_s < e_loc) & (rank >= cap))


def _experts_hit(weight):
    """The experts with at least one kept pair (weight [E_loc, C], 0 in an
    empty slot): a count for `repro_torch.obs.spans`."""
    return torch.count_nonzero(weight.amax(1))


def _rows_computed(weight, counts):
    """The rows the expert products compute (weight [E_loc, C]): every
    slot on torch.bmm's route (counts None), each expert's occupied slots
    rounded up to whole row tiles on the grouped one; a count for
    `repro_torch.obs.spans`."""
    if counts is None:
        return torch.full((), weight.numel(), dtype=torch.int64,
                          device=weight.device)
    return eg_ops.computed_rows(counts)


def _sorted_dispatch(xt, top_p, top_i, cap: int, spec: MoESpec,
                     e_lo: int = 0, e_loc: int | None = None):
    """Gather the tokens of the local experts [e_lo, e_lo + e_loc) into
    their `cap` slots (default: every expert).

    xt: [T, D].  Returns (xe [E_loc, C, D], src_idx [E_loc, C], weight
    [E_loc, C], counts [E_loc] int32) where src_idx rows index into xt (0
    and weight 0 where a slot is empty) and counts are each expert's kept
    pairs, min(its queue, cap), which fill its slots [0, count).  The
    reference's `_sorted_dispatch_local`.  The stable sort by expert id
    (non-local pairs pushed to the end) keeps each expert's queue in
    token-major (token, k) order, so the pairs past `cap` are those
    `moe_dense` drops.
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
    spans.count_device("moe.pairs_dropped", _pairs_past_cap, key_s, rank,
                       e_loc, cap)
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
    # each expert's queue starts where the sorted keys first reach it
    starts = torch.searchsorted(key_s, torch.arange(e_loc + 1, device=dev))
    counts = (starts[1:] - starts[:-1]).clamp(max=cap).to(torch.int32)
    return xe, src_idx, weight, counts


def ep_placements(placements, mesh, spec: MoESpec, expert_dim: int) -> list:
    """What a rank computes with for an expert weight held at
    `placements`: the expert dim sharded over `ep_axis`, every other mesh
    dim (the `fsdp_experts` one included) all-gathered."""
    names = list(mesh.mesh_dim_names)
    return [Shard(expert_dim) if names[i] == spec.ep_axis else Replicate()
            for i in range(len(placements))]


def moe_ep(params, x: torch.Tensor, spec: MoESpec, mesh=None,
           batch_axes=("data",), sp=()):
    """x: [B, S, D] -> (y, aux): the reference's expert-parallel body.

    Without a mesh every expert is on this device.  Under a mesh, x is
    this rank's batch shard (the same on every rank of `ep_axis`) and
    w1/w3/w2 hold this rank's E / n_ep experts ([E_loc, D, F] / [E_loc,
    F, D], gathered by `ep_placements`); the combine is summed over the ep
    ranks and aux, the router's load-balance loss over the local tokens,
    is averaged over the batch ranks (the ep ranks' values are equal, so
    this is the reference's mean over both).  Under sequence parallelism
    over the expert axis (`sp`) the combine is reduce-scattered to this
    rank's rows of the sequence instead."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    with spans.span("moe.route"):
        top_p, top_i, aux = router_probs(params, xt, spec)
        cap = _capacity(t, spec)
    spans.count("moe.pairs", t * spec.top_k)
    with spans.span("moe.dispatch"):
        if mesh is None:
            xe, src_idx, weight, counts = _sorted_dispatch(
                xt, top_p, top_i, cap, spec)
        else:
            ep = spec.ep_axis
            if ep in partition.flat_axes(batch_axes):
                raise ValueError(f"the expert axis {ep!r} also shards the "
                                 f"batch {batch_axes}")
            n_ep = partition.axis_size(mesh, ep)
            assert spec.n_experts % n_ep == 0, (spec.n_experts, n_ep)
            e_loc = spec.n_experts // n_ep
            assert params["w1"].shape[0] == e_loc, (params["w1"].shape,
                                                    e_loc)
            e_lo = partition.axis_index(mesh, ep) * e_loc
            xe, src_idx, weight, counts = _sorted_dispatch(
                partition.copy_to_group(xt, mesh, ep),
                partition.copy_to_group(top_p, mesh, ep), top_i, cap, spec,
                e_lo, e_loc)
    # the experts the product reads, and those a kept pair was routed to
    spans.count("moe.experts_read", weight.shape[0])
    spans.count_device("moe.experts_hit", _experts_hit, weight)
    # the slots the dispatch fills, and the rows the product computes
    if not _grouped(params, xe, mesh):
        counts = None
    spans.count("moe.slots", weight.numel())
    spans.count_device("moe.rows_computed", _rows_computed, weight, counts)
    with spans.span("moe.experts"):
        ye = _expert_ffn(params, xe, spec, counts)
    with spans.span("moe.combine"):
        ye = ye * weight[..., None].to(ye.dtype)
        yt = torch.zeros((t, d), dtype=ye.dtype, device=x.device)
        yt.index_add_(0, src_idx.reshape(-1), ye.reshape(-1, d))
        y = yt.reshape(b, s, d)
        if mesh is not None:
            if sp:
                y = partition.scatter_to_group(y, mesh, sp, 1)
            else:
                y = partition.reduce_from_group(y, mesh, spec.ep_axis)
            aux = _batch_mean(aux, mesh, batch_axes)
    return y, aux


def _batch_mean(aux, mesh, batch_axes):
    n_b = partition.axis_size(mesh, batch_axes)
    return partition.reduce_from_group(aux, mesh, batch_axes) / n_b


def moe_dense_sharded(params, x, spec: MoESpec, mesh, batch_axes):
    """The oracle under a mesh: x is this rank's batch shard [B_loc, S,
    D], the params hold every expert.  The oracle's capacity and queues
    span the global batch, so the shards are all-gathered over the batch
    axes, it runs over all of them, and the rank keeps its rows.  A
    token's output depends only on its own input, but the router's aux
    loss on every token: the gather's backward sums the ranks' gradients
    (`partition.gather_from_group`), and aux is averaged over the batch
    ranks as `moe_ep` does (their values are equal)."""
    b = x.shape[0]
    xs = partition.gather_from_group(x, mesh, batch_axes, 0)
    y, aux = moe_dense(params, xs, spec)
    y = y.narrow(0, partition.axis_index(mesh, batch_axes) * b, b)
    return y, _batch_mean(aux, mesh, batch_axes)


def moe_ffn(params, x, spec: MoESpec, mesh=None, batch_axes=("data",),
            sp=()):
    """The route `spec.impl` names: "dense" the oracle (under a mesh over
    the gathered batch, `moe_dense_sharded`), "ep" the gather (on one
    device) or the expert-parallel body (under a mesh).  Under sequence
    parallelism (`sp`) x is this rank's rows of the sequence: they are
    all-gathered first (the router and the capacity see every token, the
    same on every rank), and the output comes back to the rows."""
    if spec.impl not in ("dense", "ep"):
        raise ValueError(f"unknown moe impl {spec.impl!r}")
    x_in, ep_sp = x, ()
    if sp:
        x = partition.gather_whole(x, mesh, sp, 1)
    if spec.impl == "ep":
        ep_sp = sp if sp == (spec.ep_axis,) else ()
        y, aux = moe_ep(params, x, spec, mesh, batch_axes, ep_sp)
    elif mesh is None:
        y, aux = moe_dense(params, x, spec)
    else:
        y, aux = moe_dense_sharded(params, x, spec, mesh, batch_axes)
    if sp and not ep_sp:
        y = partition.split_to_group(y, mesh, sp, 1)
    return _with_shared(params, x_in, y, spec, mesh, sp), aux


def _with_shared(params, x, y, spec: MoESpec, mesh, sp):
    """y plus the shared expert of x [B, S, D] (y's rows), an expert of the
    experts' form over every token.  Added after the combine's sum over
    the expert ranks, so it counts once; under sequence parallelism x is
    this rank's rows, so the shared weights' gradients sum over `sp`."""
    if not spec.shared_d_ff:
        return y
    w = {k[len("shared_"):]: v for k, v in params.items()
         if k.startswith("shared_")}
    if sp:
        w = {k: partition.copy_to_group(v, mesh, sp) for k, v in w.items()}
    with spans.span("moe.shared", device=True):
        b, s, d = x.shape
        one = {k: v[None] for k, v in w.items()}
        return y + _expert_ffn(one, x.reshape(1, b * s, d),
                               spec).reshape(b, s, d)
