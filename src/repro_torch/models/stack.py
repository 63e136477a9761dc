"""Stacks, loss, prefill and decode steps for every family.

Mirrors `repro/models/stack.py`.  Block params keep the reference's stacked
layout (every leaf has a leading `groups` axis) and a plain Python loop
walks the groups where the reference scans.  The decode cache keeps the
reference's layouts ([G, B, S, Hkv, hd] K/V; [G, B, H, P, N] SSM state and
[G, B, K-1, C] conv tails; whisper's cross-attention [G, B, Se, Hkv, hd]
xk/xv) and is written in place.

whisper (encdec) runs its encoder over the stub frames, adds the learned
decoder positions `dec_pos` to the token embeddings, and cross-attends to
the encoder's states in every decoder sub-layer: the prefill computes the
cross k/v and keeps them in the cache, a decode step reads them back.
phi-3-vision (vlm) splices its stub patches over the first `n_patches`
positions of the prompt.

Under a mesh (`mesh`, a DeviceMesh, and `batch_axes`, the batch rule's
mesh axes, with the axis rules active: `partition.use_rules`) every rank
runs the same code on its own tensors, the reference's GSPMD program
written out per rank (`Parallel`).  The params arrive as DTensors at
their rule placements.  A param dim split over a batch axis is storage
only (ZeRO-3 / FSDP): it is all-gathered one layer group at a time,
inside the group's remat region (without grad freed after the group;
under remat gathered again in the backward; without remat autograd keeps
it for the backward).  A dim split over
another mesh axis stays split and the layer computes on its share,
Megatron's tensor parallelism: attention over its whole q and kv heads
(`layers.head_split`, whatever the head counts: a kv head shared by
several ranks is held by each, and the columns of a rank's heads are cut
from the gathered projection where its stored slice is not them), the
MLP over its hidden units, the SSM over its heads, the embedding and the
unembedding (with the loss) over their vocab rows; the partial outputs
are summed over the axis.  A layer whose split does not fall on whole
heads gathers its params over the axis and computes them whole, the same
on each rank of it.  Under rules that put the sequence on mesh axes
("train": `seq` -> "model") the forward is sequence-parallel
(`Parallel.for_sequence`): between sub-layers a rank holds its S / n
rows, norms and residual adds run on them, and each sub-layer gathers
them and reduce-scatters its output back (`_seq_parallel`).  The batch
and the cache arrive as DTensors of which
the rank takes its batch shard, the attention over a sequence-sharded
cache merges over the `seq_kv` ranks (layers.py), the MoE combine sums
over the expert ranks (moe.py), and the loss sums over the batch ranks.
Outputs go back as DTensors sharded over the batch.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree as tree_mod
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import api, layers, mamba as mamba_mod, moe as moe_mod
from repro_torch.models.api import ModelConfig
from repro_torch.obs import spans
from repro_torch.sharding import partition


def _norm(sub, prefix, x, cfg: ModelConfig, par=None):
    """The norm `prefix` of `sub` over x.  Under sequence parallelism x is
    this rank's rows, so the weights' gradients sum over `par.sp`."""
    w = sub[f"{prefix}_w"]
    b = sub.get(f"{prefix}_b")
    if par is not None and par.sp:
        w = partition.copy_to_group(w, par.mesh, par.sp)
        if b is not None:
            b = partition.copy_to_group(b, par.mesh, par.sp)
    if cfg.norm_kind == "rms":
        return layers.rms_norm(x, w, cfg.norm_eps)
    return layers.layer_norm(x, w, b)


def _seq_parallel(fn, x, tp, par):
    """fn(x, tp, sp), a layer over this rank's rows x.  Without sequence
    parallelism the layer takes x as it is (sp = ()).  Under it, a layer
    tensor-parallel over the same axes gathers and reduce-scatters the
    rows itself (sp passed on); any other computes whole on the gathered
    rows, the same on every rank, and keeps this rank's rows of its
    output (`partition.gather_whole` / `split_to_group`)."""
    sp = () if par is None else par.sp
    if not sp:
        return fn(x, tp, ())
    if tuple(tp) == sp:
        return fn(x, tp, sp)
    y = fn(partition.gather_whole(x, par.mesh, sp, 1), tp, ())
    return partition.split_to_group(y, par.mesh, sp, 1)


def moe_spec(cfg: ModelConfig) -> moe_mod.MoESpec:
    m = cfg.moe
    return moe_mod.MoESpec(
        n_experts=m.n_experts, top_k=m.top_k, d_ff=m.d_ff,
        capacity_factor=m.capacity_factor, impl=m.impl,
        fsdp_experts=m.fsdp_experts, router=m.router,
        routed_scale=m.routed_scale, expert_act=m.expert_act,
        shared_d_ff=m.shared_d_ff)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """[seq, dim] fp32: sin on the even columns, cos on the odd, with the
    reference's frequencies, computed in fp32 in its order."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    step = -torch.tensor(10000.0, device=device).log() / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * step)
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# each DTensor cache leaf's group views, made once per leaf (by id, while
# the leaf lives): DTensor dispatches each `select` on the host, and a
# decode step would take every group's view of every leaf again
_GROUP_VIEWS: dict = {}


def _group_view(leaf, i: int):
    if not isinstance(leaf, DTensor):
        return leaf[i]
    key = id(leaf)
    entry = _GROUP_VIEWS.get(key)
    if entry is None or entry[0]() is not leaf:
        entry = (weakref.ref(leaf, lambda _: _GROUP_VIEWS.pop(key, None)),
                 {})
        _GROUP_VIEWS[key] = entry
    views = entry[1]
    if i not in views:
        views[i] = leaf[i]
    return views[i]


def _index(tree, i: int):
    """The i-th group of a stacked tree (views, no copies)."""
    return {k: (_index(v, i) if isinstance(v, dict) else _group_view(v, i))
            for k, v in tree.items()}


def _groups(tree) -> list[dict]:
    """Every group of a stacked tree, as views.  Each leaf is split once
    with `unbind`, whose backward is one `stack`: taking `v[i]` for every
    group instead would, under autograd, fill a zero tensor the size of
    the whole stacked leaf once per group (`select_backward`).  A param
    DTensor (or a rank's `Held` shard) gives each group's shard."""
    def split(leaf):
        if isinstance(leaf, DTensor):
            leaf = partition.Held.of(leaf)
        if isinstance(leaf, partition.Held):
            return leaf.groups()
        return leaf.unbind(0)
    parts = tree_mod.tree_map(split, tree)
    n = len(tree_mod.leaves(parts)[0])
    return [tree_mod.tree_map(lambda p: p[g], parts) for g in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """remat="dots": keep the products with no batch dimension (the
    projections and the MLP), recompute the rest, the attention's and the
    experts' batched products included; XLA's
    `dots_with_no_batch_dims_saveable`.  `torch.einsum` runs a product
    with no batch dimension as a `bmm` over a batch of 1, so such a `bmm`
    is kept as `mm` is."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    no_batch = op is aten.mm.default or (
        op is aten.bmm.default and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if no_batch
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """fn, or fn under activation checkpointing as `cfg.remat` asks:
    "full" keeps only its inputs, "dots" also its unbatched products.
    Without grad mode nothing is kept anyway, so fn runs as it is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(cfg.remat)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt
    context_fn = ckpt.noop_context_fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return run


# the span of each sub-layer's mixer (`repro_torch.obs.spans`); a "none"
# mixer (a block that is only an FFN) has none
_SPAN = {"attn": "layer.attn", "swa": "layer.attn", "mamba": "layer.ssm"}


def _post_norm(sub, prefix, y, cfg: ModelConfig, par=None):
    """y, or with sandwich norms (afmoe: `ln1_post` after the mixer,
    `ln2_post` after the FFN) its norm, before the residual add."""
    if f"{prefix}_w" not in sub:
        return y
    return _norm(sub, prefix, y, cfg, par)


def _sublayer(sub, cfg: ModelConfig, plan_item, h, positions, *,
              cache=None, cache_pos=None, enc_out=None, causal=True,
              par=None):
    """One (mixer, [cross attention,] ffn) sub-layer (mixer "none": no
    mixer and no ln1); returns (h, aux), aux the MoE layer's load-balance
    loss (0 without one).  `cache` (this
    sub-layer's views into the stacked cache) is updated in place.  A
    sub-layer with cross attention takes its k/v from `enc_out` (and keeps
    them in `cache`) or, without it, from `cache`.  Under a mesh (`par`)
    `sub` holds what this rank computes with (`Parallel.compute`)."""
    mixer, ffn = plan_item
    mesh = None if par is None else par.mesh
    tp = {} if par is None else par.tp
    batch_axes = None if par is None else par.batch_axes
    sp = () if par is None else par.sp
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    with (spans.span(_SPAN[mixer], device=True) if mixer != "none"
          else spans.NULL):
        if mixer == "none":
            y = None
        elif mixer in ("attn", "swa"):
            spec = cfg.mixer_spec(mixer)
            if not causal:
                spec = dataclasses.replace(spec, causal=False)
            # attention writes the new K/V into the cache views itself
            y = _seq_parallel(lambda x, t, s: layers.attention(
                sub["attn"], x, spec, positions, attn_impl=cfg.attn_impl,
                kv_cache=cache, cache_pos=cache_pos, mesh=mesh, tp=t,
                sp=s)[0], _norm(sub, "ln1", h, cfg, par),
                tp.get("attn", ()), par)
        elif sp:    # sequence parallelism has no cache
            y = _seq_parallel(lambda x, t, s: mamba_mod.mamba_block(
                sub["mamba"], x, cfg.mamba_spec, mesh=mesh, tp=t, sp=s)[0],
                _norm(sub, "ln1", h, cfg, par), tp.get("ssm", ()), par)
        else:
            views = None if cache is None else (
                cache["ssm"], cache["conv_x"], cache["conv_bc"])
            ssm_tp = tp.get("ssm", ())
            # under the SSM's tensor parallelism the state's local slices
            # are this rank's heads and channels; otherwise its batch
            # shard whole
            state = None if views is None else tuple(
                partition.local(v) if ssm_tp
                else partition.keep_batch(v, batch_axes) for v in views)
            y, new_state = mamba_mod.mamba_block(
                sub["mamba"], _norm(sub, "ln1", h, cfg), cfg.mamba_spec,
                state=state, mesh=mesh, tp=ssm_tp)
            if cache is not None:
                for view, old, new in zip(views, state, new_state):
                    if ssm_tp:
                        old.copy_(new)
                    else:
                        partition.store_batch(view, new, batch_axes)
        if y is not None:
            h = h + _post_norm(sub, "ln1_post", y, cfg, par)
    if "xattn" in sub:
        attn_tp = tp.get("attn", ())
        if enc_out is not None:
            ck = layers.cross_kv_from_encoder(sub["xattn"], enc_out,
                                              cfg.attn_spec, mesh, attn_tp)
            if cache is not None:
                for name, t in zip(("xk", "xv"), ck):
                    partition.store_batch(
                        cache[name], layers.all_heads(t, mesh, attn_tp,
                                                   cfg.attn_spec),
                        batch_axes)
        else:
            ck = (partition.keep_batch(cache["xk"], batch_axes),
                  partition.keep_batch(cache["xv"], batch_axes))
        # plain attention on every path, as the reference's
        h = h + _seq_parallel(lambda x, t, s: layers.attention(
            sub["xattn"], x, cfg.attn_spec, positions, attn_impl="xla",
            cross_kv=ck, mesh=mesh, tp=t, sp=s)[0],
            _norm(sub, "lnx", h, cfg, par), attn_tp, par)
    if ffn == "dense":
        with spans.span("layer.mlp", device=True):
            y = _seq_parallel(lambda x, t, s: layers.mlp(
                sub["mlp"], x, cfg.mlp_kind, mesh, t, s),
                _norm(sub, "ln2", h, cfg, par), tp.get("mlp", ()), par)
            h = h + _post_norm(sub, "ln2_post", y, cfg, par)
    elif ffn == "moe":
        sharded = () if mesh is None else (mesh, batch_axes, sp)
        with spans.span("layer.moe", device=True):
            y, aux = moe_mod.moe_ffn(sub["moe"],
                                     _norm(sub, "ln2", h, cfg, par),
                                     moe_spec(cfg), *sharded)
            h = h + _post_norm(sub, "ln2_post", y, cfg, par)
    return h, aux


def run_stack(blocks, cfg: ModelConfig, h, positions, *, plan=None,
              cache=None, cache_pos=None, enc_out=None, causal=True,
              par=None, key="blocks"):
    """Run the stacked block params over h, group by group.

    blocks: tree whose leaves have a leading `groups` axis.
    plan: the sub-layer plan of a group (default: the config's).
    cache: matching tree (leading groups axis) or None; written in place.
    enc_out: the encoder's states, for the sub-layers' cross attention.
    causal=False makes self attention non-causal (whisper's encoder).
    Each group runs under `cfg.remat` (`_remat`), as the reference's scan
    body does.  Under a mesh (`par`; `key` names the stack among the
    params) a group's params are made what this rank computes with inside
    that body: gathered there, recomputed in the backward under remat,
    and freed with the group.
    Returns (h, cache, aux), aux summed over every sub-layer of every group.
    """
    if plan is None:
        _, plan = cfg.layer_plan()
    axes = None if par is None else tree_mod.tree_map(
        lambda a: a[1:], par.axes[key])

    def body(group, cache_g, h, aux_sum, positions, enc_out):
        if par is not None:
            group = par.compute(group, axes)
        # the sequence-parallel residual stream of the reference's scan
        # carry (the identity on a rank's local tensor)
        h = partition.constrain(h, ("batch", "seq", "embed_act"))
        for i, item in enumerate(plan):
            sub_cache = None if cache_g is None else cache_g.get(f"sub{i}")
            h, aux = _sublayer(group[f"sub{i}"], cfg, item, h, positions,
                               cache=sub_cache, cache_pos=cache_pos,
                               enc_out=enc_out, causal=causal, par=par)
            aux_sum = aux_sum + aux
        return h, aux_sum

    body = _remat(body, cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for g, group in enumerate(_groups(blocks)):
        cache_g = None if cache is None else _index(cache, g)
        h, aux_sum = body(group, cache_g, h, aux_sum, positions, enc_out)
    return h, cache, aux_sum


# ---------------------------------------------------------------------------
# a rank under a mesh
# ---------------------------------------------------------------------------

# the layer kind of a params subtree, by its key
_KIND = {"attn": "attn", "xattn": "attn", "mlp": "mlp", "mamba": "ssm",
         "moe": "moe", "embed": "vocab", "lm_head": "vocab"}
# the logical axes a tensor-parallel layer kind computes split
_SPLIT = {"attn": ("q_proj", "kv_proj"), "mlp": ("mlp",),
          "ssm": ("inner", "heads_ssm"), "vocab": ("vocab",)}


@dataclasses.dataclass(frozen=True)
class Parallel:
    """How this rank computes under a mesh: its mesh and batch axes, the
    params' logical axes (`api.param_specs`), and for each layer kind the
    mesh axes it computes split over (`tp`; missing or () where the layer
    computes whole); `attn_cols`, the columns of the q and kv projections
    that this rank's attention heads take ({"q_proj": (start, size),
    "kv_proj": ...}, from `layers.head_split`); `seq`, the mesh axes the
    rules put the sequence on, and `sp`, those of this forward's sequence
    parallelism (`for_sequence`)."""
    mesh: Any
    batch_axes: tuple
    axes: dict
    tp: dict
    moe: moe_mod.MoESpec | None
    attn_cols: dict = dataclasses.field(default_factory=dict)
    seq: tuple = ()
    sp: tuple = ()
    # placements by (axes, storage placements, shape, kind): every layer
    # group asks again
    _memo: dict = dataclasses.field(default_factory=dict, compare=False)

    def for_sequence(self, s: int) -> "Parallel":
        """This rank's Parallel for a forward over `s` positions: with
        sequence parallelism over `seq` where the rules put the sequence
        on mesh axes and those split it evenly (Megatron's: between the
        sub-layers a rank holds its s / n rows)."""
        n = partition.axis_size(self.mesh, self.seq)
        sp = self.seq if n > 1 and s % n == 0 else ()
        return self if sp == self.sp else dataclasses.replace(self, sp=sp)

    def placements(self, held: partition.Held, axes: tuple, kind) -> tuple:
        """What a rank computes with of a param held at `held`, as
        (placements, narrows): every dim split over a batch axis gathered
        (FSDP), every dim of a tensor-parallel layer's split axes kept,
        the rest gathered; an expert weight of the expert-parallel MoE
        keeps its expert dim split over the expert axis
        (`moe.ep_placements`; the "dense" oracle gathers every expert).
        An attention projection dim whose stored slice is not this rank's
        heads' columns is gathered, and `narrows` ((dim, start, size)
        each) cuts those columns out."""
        key = (axes, held.placements, held.shape, kind)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        narrows = []
        if kind == "moe" and axes and axes[0] == "expert" \
                and self.moe.impl == "ep":
            pl = moe_mod.ep_placements(held.placements, self.mesh, self.moe,
                                       expert_dim=0)
        else:
            names = partition.geometry(self.mesh)[0]
            tp = self.tp.get(kind, ())
            split = _SPLIT[kind] if tp else ()
            pl = [p if isinstance(p, Shard) and names[i] in tp
                  and axes[p.dim] in split else Replicate()
                  for i, p in enumerate(held.placements)]
            for d, name in enumerate(axes):
                if kind != "attn" or name not in self.attn_cols:
                    continue
                cols = self.attn_cols[name]
                if any(isinstance(p, Shard) and p.dim == d for p in pl) \
                        and layers.local_rows(held.shape[d], self.mesh,
                                              tp) == cols:
                    continue        # the stored slice is this rank's heads
                pl = [Replicate() if isinstance(p, Shard) and p.dim == d
                      else p for p in pl]
                narrows.append((d, *cols))
        self._memo[key] = (tuple(pl), tuple(narrows))
        return self._memo[key]

    def compute(self, tree, axes, kind=None):
        """`tree` (param DTensors, or `Held` shards) as the tensors this
        rank computes with (`placements`); plain tensors as they are.  The
        gradient of a dim gathered to be cut sums over the tensor-parallel
        ranks: each computed with its own heads' columns, and the ranks
        that share a kv head each took a part of its gradient."""
        if isinstance(tree, dict):
            return {k: self.compute(v, axes[k], _KIND.get(k, kind))
                    for k, v in tree.items()}
        if isinstance(tree, DTensor):
            tree = partition.Held.of(tree)
        if not isinstance(tree, partition.Held):
            if self.tp.get(kind):
                raise ValueError(
                    f"a {kind} param under a mesh is a plain tensor: the "
                    f"layer computes on its shard "
                    f"(partition.distribute_tree)")
            return tree
        pl, narrows = self.placements(tree, axes, kind)
        out = tree.compute(pl, self.batch_axes,
                           self.tp.get(kind, ()) if narrows else ())
        for d, start, size in narrows:
            out = out.narrow(d, start, size)
        return out

    def top(self, params, key: str):
        """The params under `key` of the top level, to compute with."""
        return self.compute(params[key], self.axes[key], _KIND.get(key))


@functools.lru_cache(maxsize=32)
def _param_axes(cfg: ModelConfig) -> dict:
    return api.param_specs(cfg)


def parallel(cfg: ModelConfig, mesh, batch_axes) -> Parallel | None:
    """This rank's `Parallel` under the active axis rules; None without a
    mesh.  A layer kind computes split over the non-batch mesh axes its
    logical axes map to (one set for all of them), when those hold more
    than one rank and split it into whole heads (attention: by
    `layers.head_split`, whatever the head counts where it finds a split;
    SSM: heads, and whole B/C groups or one shared group)."""
    if mesh is None:
        return None
    rules = partition.active_rules()
    if rules is None:
        raise ValueError("a forward under a mesh needs axis rules "
                         "(partition.use_rules)")
    batch = set(partition.flat_axes(batch_axes))
    tp, attn_cols = {}, {}
    for kind, names in _SPLIT.items():
        sets = {tuple(a for a in partition.flat_axes(rules.get(n))
                      if a not in batch) for n in names}
        axes = sets.pop() if len(sets) == 1 else ()
        n = partition.axis_size(mesh, axes)
        if n == 1:
            axes = ()
        elif kind == "attn":
            split = layers.head_split(cfg.n_heads, cfg.n_kv_heads, n)
            if split is None:
                axes = ()
            else:
                q0, q1, k0, k1 = split[partition.axis_index(mesh, axes)]
                hd = cfg.head_dim
                attn_cols = {"q_proj": (q0 * hd, (q1 - q0) * hd),
                             "kv_proj": (k0 * hd, (k1 - k0) * hd)}
        elif kind == "ssm":
            ms = cfg.mamba_spec if cfg.family in ("ssm", "hybrid") else None
            if ms is None or ms.n_heads % n or (ms.n_groups > 1
                                                and ms.n_groups % n):
                axes = ()
        tp[kind] = axes
    seq = tuple(a for a in partition.flat_axes(rules.get("seq"))
                if a not in batch)
    return Parallel(mesh, tuple(partition.flat_axes(batch_axes)),
                    _param_axes(cfg), tp,
                    moe_spec(cfg) if cfg.moe is not None else None,
                    attn_cols, seq)


def _top(params, key: str, par):
    return params[key] if par is None else par.top(params, key)


def local_batch(batch, batch_axes=("data",)):
    """This rank's batch shard of every input (DTensors sharded over the
    batch axes; a plain tensor as it is)."""
    return {k: partition.keep_batch(v, batch_axes) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def _vocab_tp(par) -> tuple:
    return () if par is None else par.tp.get("vocab", ())


def embed_tokens(params, cfg: ModelConfig, tokens, par=None):
    """The tokens' embeddings, times sqrt(d_model) under `mup_embed`
    (afmoe's muP input scale).  Under the vocab's tensor parallelism a
    rank holds rows [v0, v0 + n) of the table: it looks up the tokens
    that fall there, zeros for the rest, and the ranks' lookups sum (one
    term is not zero, so the sum is the row exactly).  Under sequence
    parallelism (`par.sp`) this rank's positions: the sum is
    reduce-scattered to them (or, with the table whole, they are cut)."""
    e = _lookup(params, cfg, tokens, par)
    return e * cfg.d_model ** 0.5 if cfg.mup_embed else e


def _lookup(params, cfg: ModelConfig, tokens, par=None):
    tok = _top(params, "embed", par)["tok"]
    tp = _vocab_tp(par)
    sp = () if par is None else par.sp
    if not tp:
        e = tok[tokens].to(cfg.compute_dtype)
        return partition.split_to_group(e, par.mesh, sp, 1) if sp else e
    v0, n = layers.local_rows(cfg.padded_vocab, par.mesh, tp)
    idx = tokens - v0
    inside = (idx >= 0) & (idx < n)
    e = tok[idx.clamp(0, max(n - 1, 0))] if n else tok.new_zeros(
        tuple(tokens.shape) + (tok.shape[1],))
    e = torch.where(inside[..., None], e, 0.0)
    if sp == tuple(tp):
        e = partition.scatter_to_group(e, par.mesh, sp, 1)
    else:
        e = partition.reduce_from_group(e, par.mesh, tp)
        if sp:
            e = partition.split_to_group(e, par.mesh, sp, 1)
    return e.to(cfg.compute_dtype)


def _seq_rows(par, s: int) -> tuple[int, int]:
    """(start, size) of this rank's positions of `s` under sequence
    parallelism; every position without it."""
    if par is None or not par.sp:
        return 0, s
    m = s // partition.axis_size(par.mesh, par.sp)
    return partition.axis_index(par.mesh, par.sp) * m, m


def _unembed_weight(params, cfg: ModelConfig, par=None):
    """The unembedding [D, Vp] (a rank's vocab columns under the vocab's
    tensor parallelism) in the compute dtype."""
    if cfg.tie_embeddings:
        return _top(params, "embed", par)["tok"].to(cfg.compute_dtype).T
    return _top(params, "lm_head", par).to(cfg.compute_dtype)


def _logits(w, cfg: ModelConfig, h, par=None, entered=False):
    """Logits in fp32 of h against the unembedding `w`; padding slots are
    -1e30.  Under the vocab's tensor parallelism, this rank's columns
    (h the same on each rank of it, or `entered`: gathered over it by
    `partition.gather_from_group`, whose backward sums)."""
    tp = _vocab_tp(par)
    v0 = 0
    if tp:
        v0 = layers.local_rows(cfg.padded_vocab, par.mesh, tp)[0]
        if not entered:
            h = partition.copy_to_group(h, par.mesh, tp)
    logits = torch.einsum("bsd,dv->bsv", h.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        vpos = v0 + torch.arange(logits.shape[-1], device=h.device)
        logits = torch.where(vpos < cfg.vocab, logits, -1e30)
    return logits


def unembed(params, cfg: ModelConfig, h, par=None):
    """Logits in fp32 over the padded vocab; padding slots are -1e30.
    Under the vocab's tensor parallelism, this rank's vocab columns
    (`whole_vocab` gathers them)."""
    return _logits(_unembed_weight(params, cfg, par), cfg, h, par)


def whole_vocab(logits, cfg: ModelConfig, par=None):
    """Logits over the whole vocab: the ranks' columns all-gathered under
    the vocab's tensor parallelism (no gradient)."""
    tp = _vocab_tp(par)
    if not tp:
        return logits
    names = partition.geometry(par.mesh)[0]
    last = logits.dim() - 1
    pl = [Shard(last) if names[i] in tp else Replicate()
          for i in range(len(names))]
    shape = tuple(logits.shape[:-1]) + (cfg.padded_vocab,)
    return partition.gather_to(DTensor.from_local(
        logits.contiguous(), par.mesh, pl, shape=shape,
        stride=torch.empty(shape, device="meta").stride()),
        [Replicate()] * len(names))


# ---------------------------------------------------------------------------
# full forward and loss
# ---------------------------------------------------------------------------


def _encode(params, cfg: ModelConfig, frames, par=None):
    """whisper's encoder over stub frame embeddings [B, Se, D]: sinusoidal
    positions, the non-causal `enc_blocks` stack, then `enc_final`."""
    se = frames.shape[1]
    if par is not None and par.sp:      # the encoder runs whole
        par = dataclasses.replace(par, sp=())
    h = frames.to(cfg.compute_dtype)
    h = h + sinusoidal_positions(se, cfg.d_model, frames.device).to(
        cfg.compute_dtype)
    positions = torch.arange(se, device=frames.device)
    h, _, _ = run_stack(params["enc_blocks"], cfg, h, positions,
                        plan=[("attn", "dense")], causal=False, par=par,
                        key="enc_blocks")
    return _norm(_top(params, "enc_final", par), "lnf", h, cfg)


def _decoder_inputs(params, cfg: ModelConfig, batch, par=None):
    """The decoder's input states [B, S, D] and the encoder's output (None
    but for whisper): token embeddings, plus `dec_pos[:S]` for whisper; for
    phi-3-vision the patches in place of the first n_patches positions."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens, par)
    s0, m = _seq_rows(par, tokens.shape[1])
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, batch["frames"], par)
        pos = _top(params, "dec_pos", par)
        if par is not None and par.sp:  # added to this rank's rows
            pos = partition.copy_to_group(pos, par.mesh, par.sp)
        h = h + pos[s0:s0 + m].to(cfg.compute_dtype)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.compute_dtype)
        n = min(max(patches.shape[1] - s0, 0), m)   # patch rows held here
        h = torch.cat([patches[:, s0:s0 + n], h[:, n:]], dim=1)
    return h, enc_out


def _forward_local(params, cfg: ModelConfig, batch, par=None):
    """(h, aux) of this rank's batch; under sequence parallelism
    (`par.sp`) h is this rank's positions."""
    tokens = batch["tokens"]
    h, enc_out = _decoder_inputs(params, cfg, batch, par)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _, aux = run_stack(params["blocks"], cfg, h, positions,
                          enc_out=enc_out, par=par)
    h = _norm(_top(params, "final", par), "lnf", h, cfg, par)
    return h, aux


def forward(params, cfg: ModelConfig, batch, *, mesh=None,
            batch_axes=("data",)):
    """Teacher-forcing forward. batch: {"tokens": [B, S]} (+ "frames" for
    whisper, "patches" for phi-3-vision).  Returns (h_final, aux); aux is
    the MoE layers' summed load-balance loss (0 for the other families).
    Under a mesh h is a DTensor sharded over the batch."""
    if mesh is None:
        return _forward_local(params, cfg, batch)
    batch = local_batch(batch, batch_axes)
    par = parallel(cfg, mesh, batch_axes).for_sequence(
        batch["tokens"].shape[1])
    h, aux = _forward_local(params, cfg, batch, par)
    if par.sp:
        h = partition.gather_whole(h, mesh, par.sp, 1)
    return partition.batch_dtensor(h, mesh, batch_axes), aux


def _gold_logit(logits, targets):
    """logits[..., targets] by a masked sum over the vocab, not a gather:
    under a vocab-sharded layout a gather along the vocab would all-gather
    the logits, the masked sum reduces where they lie.  Every term but
    one is +0.0, so the sum is the gathered value exactly."""
    vpos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vpos == targets[..., None], logits, 0.0).sum(dim=-1)


def _ce_sum(w, cfg: ModelConfig, h, targets, par=None, entered=False):
    """The CE summed over h's positions.  Under the vocab's tensor
    parallelism each rank holds its vocab columns of the logits: the
    log-sum-exp merges by the global max and the summed exponentials, the
    gold logit by the ranks' masked sums (one of them holds it)."""
    logits = _logits(w, cfg, h, par, entered)
    tp = _vocab_tp(par)
    if not tp:
        lse = torch.logsumexp(logits, dim=-1)
        return (lse - _gold_logit(logits, targets)).sum()
    mesh = par.mesh
    v0 = layers.local_rows(cfg.padded_vocab, mesh, tp)[0]
    m = partition.all_reduce(logits.detach().amax(dim=-1), mesh, tp,
                             torch.distributed.ReduceOp.MAX)
    se = partition.reduce_from_group(
        torch.exp(logits - m[..., None]).sum(dim=-1), mesh, tp)
    gold = partition.reduce_from_group(_gold_logit(logits, targets - v0),
                                       mesh, tp)
    return (m + torch.log(se) - gold).sum()


def loss_from_hidden(params, cfg: ModelConfig, h, tokens, aux, par=None):
    """Next-token CE, optionally chunked over the sequence to avoid
    materialising [B, S, V] logits at once.  Under a mesh (`par`) h and
    tokens are this rank's batch shard: the CE sums add over the batch
    ranks (the gradient of each rank's sum stays its own), and the mean
    is over the global batch.  Under sequence parallelism h is this
    rank's positions, all-gathered here (over the vocab's ranks, each of
    which then takes its columns, the gradient summed back)."""
    b, s = tokens.shape
    entered = False
    if par is not None and par.sp:
        entered = _vocab_tp(par) == par.sp
        gather = (partition.gather_from_group if entered
                  else partition.gather_whole)
        h = gather(h, par.mesh, par.sp, 1)
    targets = tokens[:, 1:]
    hh = h[:, :-1]
    n = b * (s - 1)
    w = _unembed_weight(params, cfg, par)
    if cfg.loss_chunk and (s - 1) % cfg.loss_chunk == 0:
        c = cfg.loss_chunk
        total = sum(_ce_sum(w, cfg, hh[:, i:i + c], targets[:, i:i + c],
                            par, entered)
                    for i in range(0, s - 1, c))
    else:
        total = _ce_sum(w, cfg, hh, targets, par, entered)
    if par is not None:
        total = partition.reduce_from_group(total, par.mesh, par.batch_axes)
        n *= partition.axis_size(par.mesh, par.batch_axes)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return total / n + aux_w * aux


def local_loss(params, cfg: ModelConfig, batch, par=None):
    """The loss from this rank's params (DTensors or `Held` shards, made
    what it computes with layer by layer) and batch shard (`local_batch`);
    equal on every rank under a mesh, and its gradient on a rank is that
    rank's share."""
    if par is not None:
        par = par.for_sequence(batch["tokens"].shape[1])
    h, aux = _forward_local(params, cfg, batch, par)
    return loss_from_hidden(params, cfg, h, batch["tokens"], aux, par)


def build_loss_fn(cfg: ModelConfig, mesh=None, batch_axes=("data",)):
    def loss_fn(params, batch):
        if mesh is None:
            return local_loss(params, cfg, batch)
        return local_loss(params, cfg, local_batch(batch, batch_axes),
                          parallel(cfg, mesh, batch_axes))
    return loss_fn


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    n_groups, plan = cfg.layer_plan()
    group = {}
    for i, (mixer, _) in enumerate(plan):
        if mixer == "none":
            continue
        if mixer in ("attn", "swa"):
            # a window layer's K/V: a ring of its last W positions
            rows = (min(max_len, cfg.sliding_window)
                    if mixer == "swa" and cfg.sliding_window else max_len)
            kv_shape = (n_groups, batch, rows, cfg.n_kv_heads, cfg.head_dim)
            group[f"sub{i}"] = {"k": (kv_shape, cfg.kv_dtype),
                                "v": (kv_shape, cfg.kv_dtype)}
        else:
            ms = cfg.mamba_spec
            k1 = ms.conv_kernel - 1
            group[f"sub{i}"] = {
                "ssm": ((n_groups, batch, ms.n_heads, ms.headdim,
                         ms.d_state), torch.float32),
                "conv_x": ((n_groups, batch, k1, ms.d_inner), cfg.kv_dtype),
                "conv_bc": ((n_groups, batch, k1, ms.bc_dim), cfg.kv_dtype)}
        if cfg.family == "encdec":
            x_shape = (n_groups, batch, cfg.enc_seq, cfg.n_kv_heads,
                       cfg.head_dim)
            group[f"sub{i}"].update(xk=(x_shape, cfg.kv_dtype),
                                    xv=(x_shape, cfg.kv_dtype))
    return group


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache as `meta` tensors (shapes and dtypes only)."""
    return {name: {k: torch.empty(shape, dtype=dtype, device="meta")
                   for k, (shape, dtype) in sub.items()}
            for name, sub in _cache_shapes(cfg, batch, max_len).items()}


def cache_axis_specs(cfg: ModelConfig, enc_len: int = 0) -> dict:
    """Logical axes tree matching the cache."""
    _, plan = cfg.layer_plan()
    group = {}
    for i, (mixer, _) in enumerate(plan):
        if mixer == "none":
            continue
        if mixer in ("attn", "swa"):
            ax = ("layers", "batch", "seq_kv", "kv_heads_kv", None)
            sub = {"k": ax, "v": ax}
        else:
            sub = {"ssm": ("layers", "batch", "heads_ssm", None, None),
                   "conv_x": ("layers", "batch", None, "inner"),
                   "conv_bc": ("layers", "batch", None, None)}
        if cfg.family == "encdec":
            ax = ("layers", "batch", None, "kv_heads_kv", None)
            sub.update(xk=ax, xv=ax)
        group[f"sub{i}"] = sub
    return group


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               mesh=None, rules=None):
    """Zeros; under a mesh DTensors at the placements `rules` give
    `cache_axis_specs` (each rank allocates its slice)."""
    shapes = _cache_shapes(cfg, batch, max_len)
    if mesh is None:
        return {name: {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in sub.items()}
                for name, sub in shapes.items()}
    if rules is None:
        raise ValueError("a cache under a mesh needs axis rules "
                         "(partition.use_rules)")
    axes = cache_axis_specs(cfg)
    return {name: {k: partition.zeros(
        shape, dtype, mesh, partition.to_placements(axes[name][k], rules,
                                                    mesh))
        for k, (shape, dtype) in sub.items()}
        for name, sub in shapes.items()}


def build_prefill_fn(cfg: ModelConfig, max_len: int, mesh=None,
                     batch_axes=("data",)):
    """prefill(params, batch) -> (cache, last_logits [B, V]); batch as
    `forward` takes it.  Under a mesh (with `partition.use_rules` active)
    the cache and the logits are DTensors."""
    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len, tokens.device, mesh,
                           partition.active_rules())
        par = parallel(cfg, mesh, batch_axes)
        if par is not None:
            batch = local_batch(batch, batch_axes)
            tokens = batch["tokens"]
        h, enc_out = _decoder_inputs(params, cfg, batch, par)
        positions = torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=0, enc_out=enc_out,
                                par=par)
        h = _norm(_top(params, "final", par), "lnf", h, cfg)
        logits = whole_vocab(unembed(params, cfg, h[:, -1:], par), cfg,
                             par)[:, 0]
        if par is not None:
            logits = partition.batch_dtensor(logits, mesh, batch_axes)
        return cache, logits
    return prefill


def _decode_step(params, cfg: ModelConfig, cache, tokens, pos, par=None):
    """One decode step at position `pos`: (next_tok, logits).  `pos` is an
    int, or on one device a one-element int32 tensor on the tokens'
    device: the positions, whisper's decoder position, the cache row
    written and the decode kernel's length are then derived from it on
    the device, so a captured step reads no Python value of it."""
    s = tokens.shape[1]
    h = embed_tokens(params, cfg, tokens, par)
    positions = pos + torch.arange(s, device=tokens.device)
    if cfg.family == "encdec":
        dec_pos = _top(params, "dec_pos", par)
        rows = (dec_pos.index_select(0, positions)
                if isinstance(pos, torch.Tensor) else dec_pos[pos:pos + s])
        h = h + rows.to(cfg.compute_dtype)
    h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                            cache=cache, cache_pos=pos, par=par)
    h = _norm(_top(params, "final", par), "lnf", h, cfg)
    logits = whole_vocab(unembed(params, cfg, h, par), cfg, par)[:, -1]
    return logits.argmax(dim=-1).to(tokens.dtype), logits


# the kernel wrappers' launch counters, which a replayed graph does not
# advance itself
_LAUNCH_COUNTERS = (da_ops.decode_attention, ssd_ops.ssd)
# the shapes an eager decode step has run on in this process: a step of
# these shapes is captured without another warm-up
_WARM: set = set()
# a device's capture stream (cuBLAS keeps a workspace for each stream it
# has run on) and its latest graph, whose memory the next capture shares
_CAPTURE_STREAMS: dict = {}
_LATEST: dict = {}


def _layout(tree) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tree_mod.leaves(tree))


@dataclasses.dataclass
class _Graph:
    graph: Any
    tokens: torch.Tensor        # the inputs, set before each replay
    pos: torch.Tensor
    next_tok: torch.Tensor      # the outputs, cloned after each replay
    logits: torch.Tensor
    launched: tuple             # (counter, launches a replay makes)


def _capture(cfg: ModelConfig, params, cache, tokens) -> _Graph:
    """The decode step on `params`, `cache` and a copy of `tokens`,
    captured on the device's capture stream into the memory pool of the
    device's latest graph (the graphs of successive calls replay one at a
    time on one stream, and each copies its outputs out before the next
    runs).  Spans are paused (nothing recorded there runs until a
    replay), and the launch counters are left as they were."""
    dev = tokens.device
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    latest = _LATEST.get(dev)
    graph = torch.cuda.CUDAGraph()
    static = tokens.clone()
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    before = [c.launches for c in _LAUNCH_COUNTERS]
    with spans.paused(), torch.cuda.stream(_CAPTURE_STREAMS[dev]):
        graph.capture_begin(None if latest is None else latest.graph.pool(),
                            capture_error_mode="thread_local")
        try:
            out = _decode_step(params, cfg, cache, static, pos)
        finally:
            graph.capture_end()
    launched = tuple((c, c.launches - n) for c, n in
                     zip(_LAUNCH_COUNTERS, before) if c.launches > n)
    for c, n in zip(_LAUNCH_COUNTERS, before):
        c.launches = n          # captured, not launched
    spans.count("serve.decode_graph.captures", 1)
    _LATEST[dev] = _Graph(graph, static, pos, *out, launched)
    return _LATEST[dev]


def release_decode_graphs() -> None:
    """Forget the shapes warmed up and drop each device's latest graph
    (and the memory it holds)."""
    _WARM.clear()
    _LATEST.clear()


class _DecodeGraph:
    """The single-device decode step, `build_decode_fn`'s without a mesh.

    The step reads its position from a one-element int32 tensor on the
    tokens' device, set by one `fill_` a call.  On the CPU it runs eager
    on it.  On a CUDA device the whole step is captured in one CUDA graph
    and replayed.  The graph serves one input layout: the config, the
    tokens' shape and the data pointers, shapes and strides of the params
    and of the cache; a call on another layout captures again.  The first
    step of shapes the process has not run yet runs eager (the warm-up);
    any other step of a new layout is captured, and it and every later
    step of that layout are replays.  A replay copies the tokens and the
    position into the graph's inputs and returns clones of its outputs,
    so a later call overwrites nothing the caller holds; the cache is
    written in place, as the eager step writes it.  After each replay the
    kernel wrappers' launch counters advance by the launches the graph
    holds."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pos = None
        self.key = self.graph = None

    def __call__(self, params, cache, tokens, pos: int):
        dev = tokens.device
        if dev.type == "cuda":
            layout = (_layout(params), _layout(cache))
            key = (self.cfg, tuple(tokens.shape), tokens.dtype, dev, layout)
            if key != self.key:
                shapes = (key[:4], tuple(tuple(t[1:] for t in part)
                                         for part in layout))
                if shapes in _WARM:
                    self.graph = _capture(self.cfg, params, cache, tokens)
                    self.key = key
                else:
                    _WARM.add(shapes)   # this eager step is the warm-up
            if key == self.key:
                g = self.graph
                g.tokens.copy_(tokens)
                g.pos.fill_(pos)
                g.graph.replay()
                for counter, n in g.launched:
                    counter.launches += n
                spans.count("serve.decode_graph.replays", 1)
                return cache, g.next_tok.clone(), g.logits.clone()
        if self.pos is None or self.pos.device != dev:
            self.pos = torch.zeros(1, dtype=torch.int32, device=dev)
        self.pos.fill_(pos)
        next_tok, logits = _decode_step(params, self.cfg, cache, tokens,
                                        self.pos)
        return cache, next_tok, logits


def build_decode_fn(cfg: ModelConfig, mesh=None, batch_axes=("data",)):
    """decode(params, cache, tokens [B,1], pos: int) -> (cache, next_tok,
    logits).  The cache is updated in place and returned; next_tok and
    logits are the caller's.  Without a mesh the step reads its position
    from the device and, on a CUDA device, is replayed from a CUDA graph
    (`_DecodeGraph`); under a mesh it runs eager, and the tokens, next_tok
    and logits are DTensors sharded over the batch."""
    if mesh is None:
        return _DecodeGraph(cfg)

    def decode(params, cache, tokens, pos: int):
        par = parallel(cfg, mesh, batch_axes)
        tokens = partition.keep_batch(tokens, batch_axes)
        next_tok, logits = _decode_step(params, cfg, cache, tokens, pos, par)
        return (cache, partition.batch_dtensor(next_tok, mesh, batch_axes),
                partition.batch_dtensor(logits, mesh, batch_axes))
    return decode
