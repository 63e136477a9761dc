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
Megatron's tensor parallelism: attention over its q and kv heads, the MLP
over its hidden units, the SSM over its heads, the embedding and the
unembedding (with the loss) over their vocab rows; the partial outputs
are summed over the axis.  A layer whose split does not fall on whole
heads gathers its params over the axis and computes them whole, the same
on each rank of it.  The batch and the cache arrive as DTensors of which
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
from repro_torch.models import api, layers, mamba as mamba_mod, moe as moe_mod
from repro_torch.models.api import ModelConfig
from repro_torch.sharding import partition


def _norm(sub, prefix, x, cfg: ModelConfig):
    if cfg.norm_kind == "rms":
        return layers.rms_norm(x, sub[f"{prefix}_w"])
    return layers.layer_norm(x, sub[f"{prefix}_w"], sub[f"{prefix}_b"])


def moe_spec(cfg: ModelConfig) -> moe_mod.MoESpec:
    m = cfg.moe
    return moe_mod.MoESpec(
        n_experts=m.n_experts, top_k=m.top_k, d_ff=m.d_ff,
        capacity_factor=m.capacity_factor, impl=m.impl,
        fsdp_experts=m.fsdp_experts)


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


def _sublayer(sub, cfg: ModelConfig, plan_item, h, positions, *,
              cache=None, cache_pos=None, enc_out=None, causal=True,
              par=None):
    """One (mixer, [cross attention,] ffn) sub-layer; returns (h, aux), aux
    the MoE layer's load-balance loss (0 without one).  `cache` (this
    sub-layer's views into the stacked cache) is updated in place.  A
    sub-layer with cross attention takes its k/v from `enc_out` (and keeps
    them in `cache`) or, without it, from `cache`.  Under a mesh (`par`)
    `sub` holds what this rank computes with (`Parallel.compute`)."""
    mixer, ffn = plan_item
    mesh = None if par is None else par.mesh
    tp = {} if par is None else par.tp
    batch_axes = None if par is None else par.batch_axes
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mixer == "attn":
        spec = cfg.attn_spec
        if not causal:
            spec = dataclasses.replace(spec, causal=False)
        # attention writes the new K/V into the cache views itself
        y, _ = layers.attention(
            sub["attn"], _norm(sub, "ln1", h, cfg), spec, positions,
            attn_impl=cfg.attn_impl, kv_cache=cache, cache_pos=cache_pos,
            mesh=mesh, tp=tp.get("attn", ()))
    else:
        views = None if cache is None else (
            cache["ssm"], cache["conv_x"], cache["conv_bc"])
        ssm_tp = tp.get("ssm", ())
        # under the SSM's tensor parallelism the state's local slices are
        # this rank's heads and channels; otherwise its batch shard whole
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
    h = h + y
    if "xattn" in sub:
        attn_tp = tp.get("attn", ())
        if enc_out is not None:
            ck = layers.cross_kv_from_encoder(sub["xattn"], enc_out,
                                              cfg.attn_spec, mesh, attn_tp)
            if cache is not None:
                for name, t in zip(("xk", "xv"), ck):
                    partition.store_batch(
                        cache[name], layers.all_heads(t, mesh, attn_tp),
                        batch_axes)
        else:
            ck = (partition.keep_batch(cache["xk"], batch_axes),
                  partition.keep_batch(cache["xv"], batch_axes))
        # plain attention on every path, as the reference's
        y, _ = layers.attention(
            sub["xattn"], _norm(sub, "lnx", h, cfg), cfg.attn_spec,
            positions, attn_impl="xla", cross_kv=ck, mesh=mesh, tp=attn_tp)
        h = h + y
    if ffn == "dense":
        h = h + layers.mlp(sub["mlp"], _norm(sub, "ln2", h, cfg),
                           cfg.mlp_kind, mesh, tp.get("mlp", ()))
    elif ffn == "moe":
        sharded = () if mesh is None else (mesh, batch_axes)
        y, aux = moe_mod.moe_ffn(sub["moe"], _norm(sub, "ln2", h, cfg),
                                 moe_spec(cfg), *sharded)
        h = h + y
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
            sub_cache = None if cache_g is None else cache_g[f"sub{i}"]
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
    computes whole)."""
    mesh: Any
    batch_axes: tuple
    axes: dict
    tp: dict
    moe: moe_mod.MoESpec | None
    # placements by (axes, storage placements, kind): every layer group
    # asks again
    _memo: dict = dataclasses.field(default_factory=dict, compare=False)

    def placements(self, held: partition.Held, axes: tuple, kind) -> list:
        """What a rank computes with of a param held at `held`: every
        dim split over a batch axis gathered (FSDP), every dim of a
        tensor-parallel layer's split axes kept, the rest gathered; an
        expert weight of the expert-parallel MoE keeps its expert dim
        split over the expert axis (`moe.ep_placements`)."""
        key = (axes, held.placements, kind)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        if kind == "moe" and axes and axes[0] == "expert":
            pl = moe_mod.ep_placements(held.placements, self.mesh, self.moe,
                                       expert_dim=0)
        else:
            names = partition.geometry(self.mesh)[0]
            tp = self.tp.get(kind, ())
            split = _SPLIT[kind] if tp else ()
            pl = [p if isinstance(p, Shard) and names[i] in tp
                  and axes[p.dim] in split else Replicate()
                  for i, p in enumerate(held.placements)]
        self._memo[key] = tuple(pl)
        return self._memo[key]

    def compute(self, tree, axes, kind=None):
        """`tree` (param DTensors, or `Held` shards) as the tensors this
        rank computes with (`placements`); plain tensors as they are."""
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
        return tree.compute(self.placements(tree, axes, kind),
                            self.batch_axes)

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
    than one rank and split it into whole heads (attention: q and kv
    heads; SSM: heads, and whole B/C groups or one shared group)."""
    if mesh is None:
        return None
    rules = partition.active_rules()
    if rules is None:
        raise ValueError("a forward under a mesh needs axis rules "
                         "(partition.use_rules)")
    batch = set(partition.flat_axes(batch_axes))
    tp = {}
    for kind, names in _SPLIT.items():
        sets = {tuple(a for a in partition.flat_axes(rules.get(n))
                      if a not in batch) for n in names}
        axes = sets.pop() if len(sets) == 1 else ()
        n = partition.axis_size(mesh, axes)
        if n == 1:
            axes = ()
        elif kind == "attn" and (cfg.n_heads % n or cfg.n_kv_heads % n):
            axes = ()
        elif kind == "ssm":
            ms = cfg.mamba_spec if cfg.family in ("ssm", "hybrid") else None
            if ms is None or ms.n_heads % n or (ms.n_groups > 1
                                                and ms.n_groups % n):
                axes = ()
        tp[kind] = axes
    return Parallel(mesh, tuple(partition.flat_axes(batch_axes)),
                    _param_axes(cfg), tp,
                    moe_spec(cfg) if cfg.moe is not None else None)


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
    """The tokens' embeddings.  Under the vocab's tensor parallelism a
    rank holds rows [v0, v0 + n) of the table: it looks up the tokens
    that fall there, zeros for the rest, and the ranks' lookups sum (one
    term is not zero, so the sum is the row exactly)."""
    tok = _top(params, "embed", par)["tok"]
    tp = _vocab_tp(par)
    if not tp:
        return tok[tokens].to(cfg.compute_dtype)
    v0, n = layers.local_rows(cfg.padded_vocab, par.mesh, tp)
    idx = tokens - v0
    inside = (idx >= 0) & (idx < n)
    e = tok[idx.clamp(0, max(n - 1, 0))] if n else tok.new_zeros(
        tuple(tokens.shape) + (tok.shape[1],))
    e = torch.where(inside[..., None], e, 0.0)
    return partition.reduce_from_group(e, par.mesh, tp).to(cfg.compute_dtype)


def _unembed_weight(params, cfg: ModelConfig, par=None):
    """The unembedding [D, Vp] (a rank's vocab columns under the vocab's
    tensor parallelism) in the compute dtype."""
    if cfg.tie_embeddings:
        return _top(params, "embed", par)["tok"].to(cfg.compute_dtype).T
    return _top(params, "lm_head", par).to(cfg.compute_dtype)


def _logits(w, cfg: ModelConfig, h, par=None):
    """Logits in fp32 of h against the unembedding `w`; padding slots are
    -1e30.  Under the vocab's tensor parallelism, this rank's columns."""
    tp = _vocab_tp(par)
    v0 = 0
    if tp:
        v0 = layers.local_rows(cfg.padded_vocab, par.mesh, tp)[0]
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
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, batch["frames"], par)
        h = h + _top(params, "dec_pos", par)[:tokens.shape[1]].to(
            cfg.compute_dtype)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.compute_dtype)
        h = torch.cat([patches, h[:, patches.shape[1]:]], dim=1)
    return h, enc_out


def _forward_local(params, cfg: ModelConfig, batch, par=None):
    tokens = batch["tokens"]
    h, enc_out = _decoder_inputs(params, cfg, batch, par)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _, aux = run_stack(params["blocks"], cfg, h, positions,
                          enc_out=enc_out, par=par)
    h = _norm(_top(params, "final", par), "lnf", h, cfg)
    return h, aux


def forward(params, cfg: ModelConfig, batch, *, mesh=None,
            batch_axes=("data",)):
    """Teacher-forcing forward. batch: {"tokens": [B, S]} (+ "frames" for
    whisper, "patches" for phi-3-vision).  Returns (h_final, aux); aux is
    the MoE layers' summed load-balance loss (0 for the other families).
    Under a mesh h is a DTensor sharded over the batch."""
    if mesh is None:
        return _forward_local(params, cfg, batch)
    h, aux = _forward_local(params, cfg, local_batch(batch, batch_axes),
                            parallel(cfg, mesh, batch_axes))
    return partition.batch_dtensor(h, mesh, batch_axes), aux


def _gold_logit(logits, targets):
    """logits[..., targets] by a masked sum over the vocab, not a gather:
    under a vocab-sharded layout a gather along the vocab would all-gather
    the logits, the masked sum reduces where they lie.  Every term but
    one is +0.0, so the sum is the gathered value exactly."""
    vpos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vpos == targets[..., None], logits, 0.0).sum(dim=-1)


def _ce_sum(w, cfg: ModelConfig, h, targets, par=None):
    """The CE summed over h's positions.  Under the vocab's tensor
    parallelism each rank holds its vocab columns of the logits: the
    log-sum-exp merges by the global max and the summed exponentials, the
    gold logit by the ranks' masked sums (one of them holds it)."""
    logits = _logits(w, cfg, h, par)
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
    is over the global batch."""
    b, s = tokens.shape
    targets = tokens[:, 1:]
    hh = h[:, :-1]
    n = b * (s - 1)
    w = _unembed_weight(params, cfg, par)
    if cfg.loss_chunk and (s - 1) % cfg.loss_chunk == 0:
        c = cfg.loss_chunk
        total = sum(_ce_sum(w, cfg, hh[:, i:i + c], targets[:, i:i + c],
                            par)
                    for i in range(0, s - 1, c))
    else:
        total = _ce_sum(w, cfg, hh, targets, par)
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
        if mixer == "attn":
            kv_shape = (n_groups, batch, max_len, cfg.n_kv_heads,
                        cfg.head_dim)
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
        if mixer == "attn":
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


def build_decode_fn(cfg: ModelConfig, mesh=None, batch_axes=("data",)):
    """decode(params, cache, tokens [B,1], pos: int) -> (cache, next_tok,
    logits).  The cache is updated in place and returned; under a mesh the
    tokens, next_tok and logits are DTensors sharded over the batch."""
    def decode(params, cache, tokens, pos: int):
        par = parallel(cfg, mesh, batch_axes)
        if par is not None:
            tokens = partition.keep_batch(tokens, batch_axes)
        s = tokens.shape[1]
        h = embed_tokens(params, cfg, tokens, par)
        if cfg.family == "encdec":
            h = h + _top(params, "dec_pos", par)[pos:pos + s].to(
                cfg.compute_dtype)
        positions = pos + torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=pos, par=par)
        h = _norm(_top(params, "final", par), "lnf", h, cfg)
        logits = whole_vocab(unembed(params, cfg, h, par), cfg, par)[:, -1]
        next_tok = logits.argmax(dim=-1).to(tokens.dtype)
        if par is not None:
            next_tok = partition.batch_dtensor(next_tok, mesh, batch_axes)
            logits = partition.batch_dtensor(logits, mesh, batch_axes)
        return cache, next_tok, logits
    return decode
