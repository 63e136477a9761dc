"""Core layers of the model zoo (norms, attention, MLPs), single device.

Mirrors `repro/models/layers.py`: params are nested dicts of tensors and
every function takes (params, inputs, config-ish kwargs).  The reference's
`partition.constrain` calls are dropped (one device); its sequence-sharded
cache attention waits for ROADMAP A13.

Attention paths:
  - cache-free causal:  _sdpa | _chunked_sdpa (q-block loop) | flash kernel
  - cache-free non-causal (whisper's encoder): _sdpa | _chunked_sdpa
  - prefill (s > 1):    _sdpa / _chunked_sdpa over the fresh k/v, as the
    reference does (it never sends prefill through the flash kernel)
  - decode (s == 1):    _local_cached_attention | decode kernel
  - cross (whisper):    _sdpa / _chunked_sdpa, unmasked, over the encoder's
    k/v on every device, as the reference's `_sublayer` sends cross
    attention through "xla" whatever the config's attn_impl
`attn_impl="xla"` selects the plain torch math, `"pallas"` the Hopper
kernels; the names are the reference's, so configs map one-to-one.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops

ATTN_IMPLS = ("xla", "pallas")

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style half rotation)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; positions: [seq] int."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, x.device)   # [hd/2]
    angles = positions[..., None].float() * inv_freq
    angles = angles[..., None, :]                             # [..., s, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    use_rope: bool = True
    bias: bool = False
    softmax_scale: float | None = None
    attn_chunk: int = 0          # q-block size for chunked attention (0=off)
    attn_unroll: bool = False    # kept for config parity; eager loops unroll

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def _project_qkv(params, x, spec: AttentionSpec, positions):
    b, s, _ = x.shape
    q = torch.einsum("bsd,dh->bsh", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dh->bsh", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dh->bsh", x, params["wv"].to(x.dtype))
    if spec.bias:
        q = q + params["bq"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, spec.n_heads, spec.head_dim)
    k = k.reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = v.reshape(b, s, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _sdpa(q, k, v, spec: AttentionSpec, mask) -> torch.Tensor:
    """Reference attention. q:[B,Sq,Hq,hd] k,v:[B,Sk,Hkv,hd].

    GQA KV heads are repeated up to the q-head count (head h reads kv head
    h // g), scores and softmax are fp32, masked scores are -1e30.
    """
    b, sq, hq, hd = q.shape
    g = hq // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * spec.scale
    if mask is not None:
        mask = mask.reshape(mask.shape[0], mask.shape[1],
                            *mask.shape[-2:])          # [1|B,1,Sq,Sk]
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, sq, hq, hd)


def _chunked_sdpa(q, k, v, spec: AttentionSpec, q_offset, causal=True):
    """Attention evaluated per q-block so the [Sq, Sk] score matrix never
    materialises at once.  q_offset: absolute position of q[0] minus k[0]
    (for causal masking)."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    qc = spec.attn_chunk
    kpos = torch.arange(sk, device=q.device)[None, :]
    outs = []
    for start in range(0, sq, qc):
        qb = q[:, start:start + qc]
        mask = None
        if causal:
            qpos = q_offset + start + torch.arange(qb.shape[1],
                                                   device=q.device)[:, None]
            mask = (kpos <= qpos)[None, None, None]
        outs.append(_sdpa(qb, k, v, spec, mask))
    return torch.cat(outs, dim=1)


def _local_cached_attention(q, k_cache, v_cache, spec, cache_pos):
    """Single-device decode/prefill attention over a cache."""
    s = q.shape[1]
    s_max = k_cache.shape[1]
    qi = cache_pos + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s_max, device=q.device)[None, :]
    valid = (ki <= qi)[None, None, None]
    return _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), spec, valid)


def sharded_cache_attention(*args, **kwargs):
    raise NotImplementedError("sequence-sharded cache attention: ROADMAP A13")


def sharded_cache_update_attention(*args, **kwargs):
    raise NotImplementedError("sequence-sharded cache attention: ROADMAP A13")


def attention(params, x, spec: AttentionSpec, positions,
              attn_impl: str = "xla", kv_cache=None, cache_pos=None,
              cross_kv=None, mesh=None):
    """General attention entry point; returns (out [B,S,D], new_cache|None).

    - full self-attention: kv_cache is None.
    - prefill: kv_cache given, s > 1 -> attention over fresh k/v + cache fill.
    - decode: kv_cache given, s == 1 -> cached attention.
    - cross attention: cross_kv = (k, v) [B, Se, Hkv, hd] from the encoder
      states; every query sees every encoder position.
    `cache_pos` is a Python int.  The cache dict {"k", "v"} of
    [B, S_max, Hkv, hd] tensors is written in place and returned.
    """
    if mesh is not None:
        raise NotImplementedError("sharded attention: ROADMAP A13")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    b, s, _ = x.shape
    if cross_kv is not None:
        q = torch.einsum("bsd,dh->bsh", x, params["wq"].to(x.dtype))
        if spec.bias:
            q = q + params["bq"].to(x.dtype)
        q = q.reshape(b, s, spec.n_heads, spec.head_dim)
        k, v = (t.to(q.dtype) for t in cross_kv)
        if spec.attn_chunk and s > spec.attn_chunk:
            out = _chunked_sdpa(q, k, v, spec, 0, causal=False)
        else:
            out = _sdpa(q, k, v, spec, None)
        new_cache = None
    elif kv_cache is None:
        q, k, v = _project_qkv(params, x, spec, positions)
        if attn_impl == "pallas" and spec.causal:
            out = fa_ops.flash_attention(q, k, v, causal=True,
                                         scale=spec.scale)
        elif spec.attn_chunk and s > spec.attn_chunk:
            out = _chunked_sdpa(q, k, v, spec, 0, causal=spec.causal)
        else:
            mask = causal_mask(s, s, device=x.device) if spec.causal else None
            out = _sdpa(q, k, v, spec, mask)
        new_cache = None
    else:
        q, k, v = _project_qkv(params, x, spec, positions)
        # in-place cache write, where the reference returns a new cache
        # from dynamic_update_slice; copy_ casts to the cache dtype
        k_cache, v_cache = kv_cache["k"], kv_cache["v"]
        k_cache[:, cache_pos:cache_pos + s].copy_(k)
        v_cache[:, cache_pos:cache_pos + s].copy_(v)
        if s > 1:
            # prefill: attend over the fresh k/v (== cache content)
            if spec.attn_chunk and s > spec.attn_chunk:
                out = _chunked_sdpa(q, k, v, spec, 0, causal=True)
            else:
                out = _sdpa(q, k, v, spec, causal_mask(s, s, device=x.device))
        elif attn_impl == "pallas":
            out = da_ops.decode_attention(q[:, 0], k_cache, v_cache,
                                          cache_pos + s,
                                          scale=spec.scale)[:, None]
        else:
            out = _local_cached_attention(q, k_cache, v_cache, spec,
                                          cache_pos)
        new_cache = kv_cache
    out = out.reshape(b, s, spec.q_dim)
    y = torch.einsum("bsh,hd->bsd", out, params["wo"].to(x.dtype))
    if spec.bias:
        y = y + params["bo"].to(x.dtype)
    return y, new_cache


def causal_mask(sq: int, sk: int, offset: int = 0,
                device=None) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi)[None, None, None]


def cross_kv_from_encoder(params, enc: torch.Tensor, spec: AttentionSpec):
    """The cross attention's (k, v) [B, Se, Hkv, hd] from the encoder
    states [B, Se, D]: v carries its bias, k has none."""
    b, se, _ = enc.shape
    k = torch.einsum("bsd,dh->bsh", enc, params["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dh->bsh", enc, params["wv"].to(enc.dtype))
    if spec.bias:
        v = v + params["bv"].to(enc.dtype)
    return (k.reshape(b, se, spec.n_kv_heads, spec.head_dim),
            v.reshape(b, se, spec.n_kv_heads, spec.head_dim))


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    if "b_up" in params:
        h = h + params["b_up"].to(x.dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
    if "b_down" in params:
        y = y + params["b_down"].to(x.dtype)
    return y


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return swiglu_mlp(params, x)
    if kind == "gelu":
        return gelu_mlp(params, x)
    raise ValueError(f"unknown mlp kind {kind!r}")
