"""Decoder stack, loss, prefill and decode steps (dense, SSM, MoE, hybrid).

Mirrors `repro/models/stack.py`.  Block params keep the reference's stacked
layout (every leaf has a leading `groups` axis) and a plain Python loop
walks the groups where the reference scans.  The decode cache keeps the
reference's layouts ([G, B, S, Hkv, hd] K/V; [G, B, H, P, N] SSM state and
[G, B, K-1, C] conv tails) and is written in place.
"""
from __future__ import annotations

import torch

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


def _index(tree, i: int):
    """The i-th group of a stacked tree (views, no copies)."""
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _sublayer(sub, cfg: ModelConfig, plan_item, h, positions, *,
              cache=None, cache_pos=None):
    """One (mixer, ffn) sub-layer; returns (h, aux), aux the MoE layer's
    load-balance loss (0 without one).  `cache` (this sub-layer's views
    into the stacked cache) is updated in place."""
    mixer, ffn = plan_item
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mixer == "attn":
        # attention writes the new K/V into the cache views itself
        y, _ = layers.attention(
            sub["attn"], _norm(sub, "ln1", h, cfg), cfg.attn_spec, positions,
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
    if ffn == "dense":
        h = h + layers.mlp(sub["mlp"], _norm(sub, "ln2", h, cfg),
                           cfg.mlp_kind)
    elif ffn == "moe":
        y, aux = moe_mod.moe_ffn(sub["moe"], _norm(sub, "ln2", h, cfg),
                                 moe_spec(cfg))
        h = h + y
    return h, aux


def run_stack(blocks, cfg: ModelConfig, h, positions, *, cache=None,
              cache_pos=None):
    """Run the stacked block params over h, group by group.

    blocks: tree whose leaves have a leading `groups` axis.
    cache: matching tree (leading groups axis) or None; written in place.
    Returns (h, cache, aux), aux summed over every sub-layer of every group.
    """
    _, plan = cfg.layer_plan()
    n_groups = api.flatten(blocks)[0][1].shape[0]
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(n_groups):
        group = _index(blocks, g)
        cache_g = None if cache is None else _index(cache, g)
        for i, item in enumerate(plan):
            sub_cache = None if cache_g is None else cache_g[f"sub{i}"]
            h, aux = _sublayer(group[f"sub{i}"], cfg, item, h, positions,
                               cache=sub_cache, cache_pos=cache_pos)
            aux_sum = aux_sum + aux
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


def forward(params, cfg: ModelConfig, batch):
    """Teacher-forcing forward. batch: {"tokens": [B, S]}.
    Returns (h_final, aux); aux is the MoE layers' summed load-balance
    loss (0 for the dense and SSM families)."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _, aux = run_stack(params["blocks"], cfg, h, positions)
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
    return group


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {name: {k: torch.zeros(shape, dtype=dtype, device=device)
                   for k, (shape, dtype) in sub.items()}
            for name, sub in _cache_shapes(cfg, batch, max_len).items()}


def build_prefill_fn(cfg: ModelConfig, max_len: int):
    """prefill(params, batch) -> (cache, last_logits [B, V])."""
    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len, tokens.device)
        h = embed_tokens(params, cfg, tokens)
        positions = torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=0)
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
        positions = pos + torch.arange(s, device=tokens.device)
        h, cache, _ = run_stack(params["blocks"], cfg, h, positions,
                                cache=cache, cache_pos=pos)
        h = _norm(params["final"], "lnf", h, cfg)
        logits = unembed(params, cfg, h)[:, -1]
        next_tok = logits.argmax(dim=-1).to(tokens.dtype)
        return cache, next_tok, logits
    return decode
