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
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import tree as tree_mod
from repro_torch.models import api, layers, mamba as mamba_mod, moe as moe_mod
from repro_torch.models.api import ModelConfig


def _norm(sub, prefix, x, cfg: ModelConfig):
    if cfg.norm_kind == "rms":
        return layers.rms_norm(x, sub[f"{prefix}_w"])
    return layers.layer_norm(x, sub[f"{prefix}_w"], sub[f"{prefix}_b"])


def moe_spec(cfg: ModelConfig) -> moe_mod.MoESpec:
    m = cfg.moe
    return moe_mod.MoESpec(
        n_experts=m.n_experts, top_k=m.top_k, d_ff=m.d_ff,
        capacity_factor=m.capacity_factor, impl=m.impl)


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


def _index(tree, i: int):
    """The i-th group of a stacked tree (views, no copies)."""
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _groups(tree) -> list[dict]:
    """Every group of a stacked tree, as views.  Each leaf is split once
    with `unbind`, whose backward is one `stack`: taking `v[i]` for every
    group instead would, under autograd, fill a zero tensor the size of
    the whole stacked leaf once per group (`select_backward`)."""
    parts = tree_mod.tree_map(lambda leaf: leaf.unbind(0), tree)
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
              cache=None, cache_pos=None, enc_out=None, causal=True):
    """One (mixer, [cross attention,] ffn) sub-layer; returns (h, aux), aux
    the MoE layer's load-balance loss (0 without one).  `cache` (this
    sub-layer's views into the stacked cache) is updated in place.  A
    sub-layer with cross attention takes its k/v from `enc_out` (and keeps
    them in `cache`) or, without it, from `cache`."""
    mixer, ffn = plan_item
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mixer == "attn":
        spec = cfg.attn_spec
        if not causal:
            spec = dataclasses.replace(spec, causal=False)
        # attention writes the new K/V into the cache views itself
        y, _ = layers.attention(
            sub["attn"], _norm(sub, "ln1", h, cfg), spec, positions,
            attn_impl=cfg.attn_impl, kv_cache=cache, cache_pos=cache_pos)
    else:
        state = None if cache is None else (
            cache["ssm"], cache["conv_x"], cache["conv_bc"])
        y, new_state = mamba_mod.mamba_block(
            sub["mamba"], _norm(sub, "ln1", h, cfg), cfg.mamba_spec,
            state=state)
        if cache is not None:
            for view, new in zip(state, new_state):
                view.copy_(new)
    h = h + y
    if "xattn" in sub:
        if enc_out is not None:
            ck = layers.cross_kv_from_encoder(sub["xattn"], enc_out,
                                              cfg.attn_spec)
            if cache is not None:
                cache["xk"].copy_(ck[0])
                cache["xv"].copy_(ck[1])
        else:
            ck = (cache["xk"], cache["xv"])
        # plain attention on every path, as the reference's
        y, _ = layers.attention(
            sub["xattn"], _norm(sub, "lnx", h, cfg), cfg.attn_spec,
            positions, attn_impl="xla", cross_kv=ck)
        h = h + y
    if ffn == "dense":
        h = h + layers.mlp(sub["mlp"], _norm(sub, "ln2", h, cfg),
                           cfg.mlp_kind)
    elif ffn == "moe":
        y, aux = moe_mod.moe_ffn(sub["moe"], _norm(sub, "ln2", h, cfg),
                                 moe_spec(cfg))
        h = h + y
    return h, aux


def run_stack(blocks, cfg: ModelConfig, h, positions, *, plan=None,
              cache=None, cache_pos=None, enc_out=None, causal=True):
    """Run the stacked block params over h, group by group.

    blocks: tree whose leaves have a leading `groups` axis.
    plan: the sub-layer plan of a group (default: the config's).
    cache: matching tree (leading groups axis) or None; written in place.
    enc_out: the encoder's states, for the sub-layers' cross attention.
    causal=False makes self attention non-causal (whisper's encoder).
    Each group runs under `cfg.remat` (`_remat`), as the reference's scan
    body does.
    Returns (h, cache, aux), aux summed over every sub-layer of every group.
    """
    if plan is None:
        _, plan = cfg.layer_plan()

    def body(group, cache_g, h, aux_sum, positions, enc_out):
        for i, item in enumerate(plan):
            sub_cache = None if cache_g is None else cache_g[f"sub{i}"]
            h, aux = _sublayer(group[f"sub{i}"], cfg, item, h, positions,
                               cache=sub_cache, cache_pos=cache_pos,
                               enc_out=enc_out, causal=causal)
            aux_sum = aux_sum + aux
        return h, aux_sum

    body = _remat(body, cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for g, group in enumerate(_groups(blocks)):
        cache_g = None if cache is None else _index(cache, g)
        h, aux_sum = body(group, cache_g, h, aux_sum, positions, enc_out)
    return h, cache, aux_sum


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"]["tok"][tokens].to(cfg.compute_dtype)


def unembed(params, cfg: ModelConfig, h):
    """Logits in fp32 over the padded vocab; padding slots are -1e30."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(cfg.compute_dtype)      # [Vp, D]
        logits = torch.einsum("bsd,vd->bsv", h.float(), w.float())
    else:
        w = params["lm_head"].to(cfg.compute_dtype)           # [D, Vp]
        logits = torch.einsum("bsd,dv->bsv", h.float(), w.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:
        pad_mask = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# full forward and loss
# ---------------------------------------------------------------------------


def _encode(params, cfg: ModelConfig, frames):
    """whisper's encoder over stub frame embeddings [B, Se, D]: sinusoidal
    positions, the non-causal `enc_blocks` stack, then `enc_final`."""
    se = frames.shape[1]
    h = frames.to(cfg.compute_dtype)
    h = h + sinusoidal_positions(se, cfg.d_model, frames.device).to(
        cfg.compute_dtype)
    positions = torch.arange(se, device=frames.device)
    h, _, _ = run_stack(params["enc_blocks"], cfg, h, positions,
                        plan=[("attn", "dense")], causal=False)
    return _norm(params["enc_final"], "lnf", h, cfg)


def _decoder_inputs(params, cfg: ModelConfig, batch):
    """The decoder's input states [B, S, D] and the encoder's output (None
    but for whisper): token embeddings, plus `dec_pos[:S]` for whisper; for
    phi-3-vision the patches in place of the first n_patches positions."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, batch["frames"])
        h = h + params["dec_pos"][:tokens.shape[1]].to(cfg.compute_dtype)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.compute_dtype)
        h = torch.cat([patches, h[:, patches.shape[1]:]], dim=1)
    return h, enc_out


def forward(params, cfg: ModelConfig, batch):
    """Teacher-forcing forward. batch: {"tokens": [B, S]} (+ "frames" for
    whisper, "patches" for phi-3-vision).  Returns (h_final, aux); aux is
    the MoE layers' summed load-balance loss (0 for the other families)."""
    tokens = batch["tokens"]
    h, enc_out = _decoder_inputs(params, cfg, batch)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _, aux = run_stack(params["blocks"], cfg, h, positions,
                          enc_out=enc_out)
    h = _norm(params["final"], "lnf", h, cfg)
    return h, aux


def _ce_sum(params, cfg: ModelConfig, h, targets):
    logits = unembed(params, cfg, h)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - gold).sum()


def loss_from_hidden(params, cfg: ModelConfig, h, tokens, aux):
    """Next-token CE, optionally chunked over the sequence to avoid
    materialising [B, S, V] logits at once."""
    b, s = tokens.shape
    targets = tokens[:, 1:]
    hh = h[:, :-1]
    n = b * (s - 1)
    if cfg.loss_chunk and (s - 1) % cfg.loss_chunk == 0:
        c = cfg.loss_chunk
        total = sum(_ce_sum(params, cfg, hh[:, i:i + c], targets[:, i:i + c])
                    for i in range(0, s - 1, c))
    else:
        total = _ce_sum(params, cfg, hh, targets)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return total / n + aux_w * aux


def build_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        h, aux = forward(params, cfg, batch)
        return loss_from_hidden(params, cfg, h, batch["tokens"], aux)
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {name: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in sub.items()}
            for name, sub in _cache_shapes(cfg, batch, max_len).items()}


def build_prefill_fn(cfg: ModelConfig, max_len: int):
    """prefill(params, batch) -> (cache, last_logits [B, V]); batch as
    `forward` takes it."""
    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len, tokens.device)
        h, enc_out = _decoder_inputs(params, cfg, batch)
        positions = torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=0, enc_out=enc_out)
        h = _norm(params["final"], "lnf", h, cfg)
        logits = unembed(params, cfg, h[:, -1:])[:, 0]
        return cache, logits
    return prefill


def build_decode_fn(cfg: ModelConfig):
    """decode(params, cache, tokens [B,1], pos: int) -> (cache, next_tok,
    logits).  The cache is updated in place and returned."""
    def decode(params, cache, tokens, pos: int):
        s = tokens.shape[1]
        h = embed_tokens(params, cfg, tokens)
        if cfg.family == "encdec":
            h = h + params["dec_pos"][pos:pos + s].to(cfg.compute_dtype)
        positions = pos + torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=pos)
        h = _norm(params["final"], "lnf", h, cfg)
        logits = unembed(params, cfg, h)[:, -1]
        next_tok = logits.argmax(dim=-1).to(tokens.dtype)
        return cache, next_tok, logits
    return decode
