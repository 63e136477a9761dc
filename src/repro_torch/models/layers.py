"""Core layers of the model zoo (norms, attention, MLPs).

Mirrors `repro/models/layers.py`: params are nested dicts of tensors and
every function takes (params, inputs, config-ish kwargs).  Under a mesh
each rank runs these functions on its local tensors (its batch shard, its
tensor-parallel share of the weights: attention's whole heads by
`head_split`); the reference's `partition.constrain` calls are kept and
redistribute only a DTensor, so on the local tensors they are the
identity, and sequence parallelism is written out (`sp`: the rows
gathered before a layer and reduce-scattered after it).  The
reference's two `shard_map` bodies over a sequence-sharded KV cache are
per-rank functions here
(`sharded_cache_attention`, `sharded_cache_update_attention`): each rank
attends over its local slice of the cache and the partials merge by an
online softmax, `all_reduce` MAX and SUM over the ranks of the `seq_kv`
mesh axes.

Attention paths:
  - full sequence (`_attend`: the cache-free forward, the prefill over
    its fresh k/v, whisper's cross attention over the encoder's k/v): the
    flash kernel for causal attention under "pallas" (the prefill's only
    without a mesh), else _sdpa / _chunked_sdpa (q-block loop), the
    reference's route; cross attention is unmasked and, as the
    reference's `_sublayer` sends it, always "xla"
  - decode (s == 1):    _local_cached_attention | decode kernel | the
    sequence-sharded bodies under a mesh (cross: the non-causal body)
`attn_impl="xla"` selects the plain torch math, `"pallas"` the Hopper
kernels; the names are the reference's, so configs map one-to-one.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.obs import spans
from repro_torch.sharding import partition

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
    norm_eps: float = 1e-6       # the qk-norm's
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
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
        k = rms_norm(k, params["k_norm"], spec.norm_eps)
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
    q = partition.constrain(q, ("batch", "seq_attn", "heads", None))
    k = partition.constrain(k, ("batch", "seq_attn", "heads", None))
    v = partition.constrain(v, ("batch", "seq_attn", "heads", None))
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


def _attend(q, k, v, spec: AttentionSpec, attn_impl: str, *, causal: bool,
            counter: str | None = None) -> torch.Tensor:
    """Full-sequence attention, q:[B,Sq,Hq,hd] over k,v:[B,Sk,Hkv,hd] from
    row 0 (causal: Sq == Sk).  The flash kernel under "pallas" when causal,
    before `attn_chunk` (each call adds 1 to `counter`), else
    `_chunked_sdpa` where `attn_chunk` splits q, else `_sdpa`.  The mesh
    rule is the caller's: the prefill passes "xla" under a mesh, the
    cache-free forward keeps the kernel there."""
    s = q.shape[1]
    if attn_impl == "pallas" and causal:
        if counter:
            spans.count(counter, 1)
        return fa_ops.flash_attention(q, k, v, causal=True, scale=spec.scale)
    if spec.attn_chunk and s > spec.attn_chunk:
        return _chunked_sdpa(q, k, v, spec, 0, causal=causal)
    return _sdpa(q, k, v, spec,
                 causal_mask(s, s, device=q.device) if causal else None)


def _local_cached_attention(q, k_cache, v_cache, spec, cache_pos):
    """Single-device decode/prefill attention over a cache."""
    s = q.shape[1]
    s_max = k_cache.shape[1]
    qi = cache_pos + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s_max, device=q.device)[None, :]
    valid = (ki <= qi)[None, None, None]
    return _sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype), spec, valid)


def _n_seq_shards(mesh, rules) -> int:
    return partition.axis_size(mesh, rules.get("seq_kv"))


def local_rows(n_rows: int, mesh, axes) -> tuple[int, int]:
    """(start, size) of this rank's rows of a dim of `n_rows` sharded over
    `axes`: DTensor's split, ceil-sized chunks per mesh axis in mesh
    order, the last ones short or empty."""
    start, size = 0, n_rows
    names, sizes, coord = partition.geometry(mesh)
    for a in partition.flat_axes(axes):
        d = names.index(a)
        c = -(-size // sizes[d])
        i = coord[d]
        start += i * c
        size = max(0, min(c, size - i * c))
    return start, size


def _merged_partial_attention(qb, kb, vb, spec, start, s_valid, cache_pos,
                              causal, mesh, seq_flat):
    """The per-rank body of the reference's sharded cache attention: this
    rank's keys are rows [start, start + kb.shape[1]) of the global cache.
    Partial softmax over them, merged over the `seq_flat` ranks by the
    global max and sums.  Rows past `s_valid` (the pad) are masked."""
    bl, s, hq, hd = qb.shape
    s_loc = kb.shape[1]
    if s_loc == 0:      # an empty shard: one masked row keeps max defined
        kb = kb.new_zeros((bl, 1) + tuple(kb.shape[2:]))
        vb = vb.new_zeros((bl, 1) + tuple(vb.shape[2:]))
        s_loc, start = 1, s_valid
    hkv = kb.shape[2]
    g = hq // hkv
    qg = qb.reshape(bl, s, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          kb.to(qb.dtype).float()) * spec.scale
    kpos = start + torch.arange(s_loc, device=qb.device)[None, :]
    qpos = (cache_pos + torch.arange(s, device=qb.device))[:, None]
    mask = (kpos <= qpos) if causal else (kpos < s_valid)
    mask = mask & (kpos < s_valid)
    scores = torch.where(mask[None, None, None], scores, -torch.inf)
    m_glob = partition.all_reduce(scores.amax(dim=-1, keepdim=True),
                                  mesh, seq_flat, dist.ReduceOp.MAX)
    m_glob = m_glob.clamp_min(-1e30)                      # all-masked guard
    p = torch.exp(scores - m_glob)
    l_glob = partition.all_reduce(p.sum(dim=-1), mesh, seq_flat)
    o_glob = partition.all_reduce(
        torch.einsum("bhgqk,bkhd->bqhgd", p.to(vb.dtype).float(),
                     vb.float()), mesh, seq_flat)
    # l_glob [b,h,g,s] -> [b,s,h,g,1] to divide o_glob [b,s,h,g,hd]
    out = o_glob / l_glob.movedim(3, 1)[..., None]
    return out.reshape(bl, s, hq, hd).to(qb.dtype)


def _seq_slice(x: torch.Tensor, mesh, seq_flat):
    """(this rank's rows of x's dim 1 as the sequence-sharded split would
    hold them, their start)."""
    start, size = local_rows(x.shape[1], mesh, seq_flat)
    return x[:, start:start + size], start


def sharded_cache_attention(q, k_cache, v_cache, spec: AttentionSpec,
                            cache_pos, mesh, rules, causal=True):
    """Decode attention over a *sequence-sharded* KV cache, on this rank.

    q: [B_loc, s, Hq, hd], this rank's batch shard (the same on every
    rank of the `seq_kv` axes).  k_cache/v_cache: DTensors of global
    [B, S, Hkv, hd] sharded over rules["seq_kv"] (their local slices are
    read), or plain local [B_loc, S, Hkv, hd] tensors holding every row
    (cross attention's k/v), of which this rank takes its rows.  Each
    rank computes partial attention over its slice and the partials merge
    (all_reduce MAX, then SUM), equal to the global softmax.  The
    reference pads S to a multiple of the shards; here a short or empty
    last shard is masked past S instead."""
    seq_flat = partition.flat_axes(rules.get("seq_kv"))
    if not seq_flat:
        return _local_cached_attention(q, partition.local(k_cache),
                                       partition.local(v_cache), spec,
                                       cache_pos)
    s_valid = k_cache.shape[1]
    if isinstance(k_cache, DTensor):
        start, _ = local_rows(s_valid, mesh, seq_flat)
        kb, vb = k_cache.to_local(), v_cache.to_local()
    else:
        kb, start = _seq_slice(k_cache, mesh, seq_flat)
        vb, _ = _seq_slice(v_cache, mesh, seq_flat)
    return _merged_partial_attention(q, kb, vb, spec, start, s_valid,
                                     cache_pos, causal, mesh, seq_flat)


def _write_rows(cache: torch.Tensor, start: int, new: torch.Tensor,
                cache_pos) -> None:
    """Write the rows [cache_pos, cache_pos + s) of `new` that fall in
    this local slice (global rows [start, start + len)) in place.  A
    `cache_pos` held on the device (a one-element int tensor; one device,
    start 0) writes them by `index_copy_` at the rows it gives, with no
    host read."""
    if isinstance(cache_pos, torch.Tensor):
        rows = cache_pos + torch.arange(new.shape[1], device=cache.device)
        cache.index_copy_(1, rows, new.to(cache.dtype))
        return
    lo = max(cache_pos, start)
    hi = min(cache_pos + new.shape[1], start + cache.shape[1])
    if lo < hi:
        cache[:, lo - start:hi - start].copy_(
            new[:, lo - cache_pos:hi - cache_pos])


def sharded_cache_update_attention(q, k_new, v_new, k_cache, v_cache,
                                   spec: AttentionSpec, cache_pos, mesh,
                                   rules):
    """Single-token decode with the cache update inside the per-rank body:
    the rank whose slice holds `cache_pos` writes the new row into its
    local shard in place; then the merge of sharded_cache_attention.

    q: [B_loc, 1, Hq, hd]; k_new/v_new: [B_loc, 1, Hkv, hd]; caches:
    DTensors of global [B, S, Hkv, hd], sequence-sharded.
    Returns (out [B_loc,1,Hq,hd], k_cache, v_cache)."""
    seq_flat = partition.flat_axes(rules.get("seq_kv"))
    assert seq_flat, "requires a sequence-sharded cache"
    s_valid = k_cache.shape[1]
    start, _ = local_rows(s_valid, mesh, seq_flat)
    kb, vb = k_cache.to_local(), v_cache.to_local()
    _write_rows(kb, start, k_new, cache_pos)
    _write_rows(vb, start, v_new, cache_pos)
    out = _merged_partial_attention(q, kb, vb, spec, start, s_valid,
                                    cache_pos, True, mesh, seq_flat)
    return out, k_cache, v_cache


def _gathered_seq(cache: DTensor, mesh, seq_flat, heads) -> torch.Tensor:
    """This rank's batch shard of the cache with every row, all-gathered
    over the `seq_kv` axes (what GSPMD gives the reference's decode
    kernel), and of it the kv heads `heads`.  The rows come from the
    other ranks of those axes, whose own heads (when they also split the
    heads) are others: every head is gathered, then sliced."""
    names = partition.geometry(mesh)[0]
    pl = [Replicate() if names[i] in seq_flat else p
          for i, p in enumerate(cache.placements)]
    return partition.gather_to(cache, pl)[:, :, heads]


def head_split(n_heads: int, n_kv_heads: int, n: int) -> list | None:
    """Each of `n` tensor-parallel ranks' heads as (q0, q1, k0, k1): its
    q heads [q0, q1) and kv heads [k0, k1), whole heads, every q head
    beside its kv head (h // g, g = n_heads / n_kv_heads).

    - n divides the kv heads: K/n whole kv groups a rank;
    - the kv heads divide n: the n/K ranks of a kv head each hold it
      (replicated) and split its g q heads contiguously, the first
      g mod (n/K) of them one more;
    - otherwise, with n <= K: the kv groups dealt out contiguously, the
      first K mod n ranks one more (MHA's K = H heads too).
    None where none of these holds (n > K and K does not divide it, or
    fewer q heads to a kv head than its ranks): the layer computes whole.
    Rank 0 always holds the most heads."""
    if not n_kv_heads or n_heads % n_kv_heads:
        return None
    g = n_heads // n_kv_heads
    if n_kv_heads % n == 0:
        c = n_kv_heads // n
        return [(r * c * g, (r + 1) * c * g, r * c, (r + 1) * c)
                for r in range(n)]
    if n % n_kv_heads == 0:
        per = n // n_kv_heads
        if g < per:
            return None
        out = []
        for r in range(n):
            k, j = divmod(r, per)
            q0 = k * g + j * (g // per) + min(j, g % per)
            out.append((q0, q0 + g // per + (j < g % per), k, k + 1))
        return out
    if n <= n_kv_heads:
        out, k0 = [], 0
        for r in range(n):
            c = n_kv_heads // n + (r < n_kv_heads % n)
            out.append((k0 * g, (k0 + c) * g, k0, k0 + c))
            k0 += c
        return out
    return None


def tp_heads(spec: AttentionSpec, mesh, tp) -> tuple:
    """(this rank's share of the heads as an AttentionSpec, the slice of
    its q heads, the slice of its kv heads) under tensor parallelism over
    the mesh axes `tp` (`head_split`); the spec and every head without
    it."""
    if not tp:
        return spec, slice(None), slice(None)
    q0, q1, k0, k1 = head_split(spec.n_heads, spec.n_kv_heads,
                                partition.axis_size(mesh, tp))[
        partition.axis_index(mesh, tp)]
    local = dataclasses.replace(spec, n_heads=q1 - q0, n_kv_heads=k1 - k0)
    return local, slice(q0, q1), slice(k0, k1)


def all_heads(x: torch.Tensor, mesh, tp, spec: AttentionSpec,
              kv: bool = True) -> torch.Tensor:
    """[B, S, H_loc, hd] of every rank of the mesh axes `tp` joined into
    every head, in head order: the ranks' kv heads (`kv`; a kv head that
    several ranks hold is taken once) or q heads.  What a cache that
    holds every head keeps.  No gradient."""
    if not tp:
        return x
    split = head_split(spec.n_heads, spec.n_kv_heads,
                       partition.axis_size(mesh, tp))
    ranges = [(k0, k1) if kv else (q0, q1) for q0, q1, k0, k1 in split]
    width = max(hi - lo for lo, hi in ranges)
    pad = x.new_zeros(x.shape[:2] + (width - x.shape[2],) + x.shape[3:])
    parts = partition.gather_parts(torch.cat([x.detach(), pad], dim=2),
                                   mesh, tp)
    out, done = [], 0
    for part, (lo, hi) in zip(parts, ranges):
        if hi > done:
            out.append(part[:, :, done - lo:hi - lo])
            done = hi
    return torch.cat(out, dim=2)


def attention(params, x, spec: AttentionSpec, positions,
              attn_impl: str = "xla", kv_cache=None, cache_pos=None,
              cross_kv=None, mesh=None, tp=(), sp=()):
    """General attention entry point; returns (out [B,S,D], new_cache|None).

    - full self-attention: kv_cache is None.
    - prefill: kv_cache given, s > 1 -> attention over fresh k/v + cache fill.
    - decode: kv_cache given, s == 1 -> cached attention (sharded when a
      mesh is given and the active rules shard the cache's sequence).
    - cross attention: cross_kv = (k, v) [B, Se, Hkv, hd] from the encoder
      states (or this rank's kv heads of them); every query sees every
      encoder position.
    `cache_pos` is a Python int or, without a mesh, a one-element int32
    tensor on the device (the decode step's position, `stack._decode_step`):
    the cache row and the decode kernel's length are then computed on the
    device.  The cache dict {"k", "v"} of
    [B, S_max, Hkv, hd] tensors (under a mesh: DTensors, whose local
    slices are written) is written in place and returned.  The dispatch
    order is the reference's.

    `tp`: the mesh axes of Megatron's tensor parallelism.  The params are
    this rank's share of the heads (`head_split`: wq/wk/wv and their
    biases its columns, wo its rows); it attends with its q heads over
    its kv heads (a cache holds every head: the new k/v rows are
    all-gathered over `tp` to write it), and its part of the output
    projection is summed over `tp`.  The gradients of q_norm/k_norm,
    which each rank takes for its heads only, sum over `tp`.
    `sp` (the same axes as `tp`): sequence parallelism, x is this rank's
    rows of the sequence; they are all-gathered before the projections
    and the output is reduce-scattered back to them
    (`partition.tp_enter` / `tp_leave`); `bo`, added to the rows, has its
    gradient summed over `sp`.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    rules = partition.active_rules()
    whole = spec
    spec, q_heads, heads = tp_heads(spec, mesh, tp)
    x = partition.tp_enter(x, mesh, tp, sp)
    if tp and spec.qk_norm:
        params = dict(params, **{k: partition.copy_to_group(
            params[k], mesh, tp) for k in ("q_norm", "k_norm")})
    b, s, _ = x.shape

    def every_head(body, q):
        # the sequence-sharded merge sums over the `seq_kv` ranks, which
        # must attend with the same heads: q's heads are gathered from
        # the tensor-parallel ranks, and this rank keeps its heads' output
        if not tp:
            return body(q, spec)
        return body(all_heads(q, mesh, tp, whole, kv=False),
                    whole)[:, :, q_heads]

    if cross_kv is not None:
        q = torch.einsum("bsd,dh->bsh", x, params["wq"].to(x.dtype))
        if spec.bias:
            q = q + params["bq"].to(x.dtype)
        q = q.reshape(b, s, spec.n_heads, spec.head_dim)
        k, v = (partition.local(t) for t in cross_kv)
        if s == 1 and mesh is not None and rules is not None:
            if tp and k.shape[2] != whole.n_kv_heads:   # this rank's heads
                k = all_heads(k, mesh, tp, whole)
                v = all_heads(v, mesh, tp, whole)
            out = every_head(lambda qq, sp: sharded_cache_attention(
                qq, k, v, sp, 0, mesh, rules, causal=False), q)
        else:
            if tp and k.shape[2] == whole.n_kv_heads:  # a cache's: every head
                k, v = k[:, :, heads], v[:, :, heads]
            out = _attend(q, k.to(q.dtype), v.to(q.dtype), spec, attn_impl,
                          causal=False)
        new_cache = None
    elif kv_cache is None:
        q, k, v = _project_qkv(params, x, spec, positions)
        out = _attend(q, k, v, spec, attn_impl, causal=spec.causal)
        new_cache = None
    else:
        q, k, v = _project_qkv(params, x, spec, positions)
        k_cache, v_cache = kv_cache["k"], kv_cache["v"]
        k_all = all_heads(k, mesh, tp, whole)
        v_all = all_heads(v, mesh, tp, whole)
        seq_flat = (partition.flat_axes(rules.get("seq_kv"))
                    if rules is not None and mesh is not None else ())
        if s == 1 and seq_flat and \
                k_cache.shape[1] % _n_seq_shards(mesh, rules) == 0 \
                and attn_impl == "xla":
            out = every_head(lambda qq, sp: sharded_cache_update_attention(
                qq, k_all, v_all, k_cache, v_cache, sp, cache_pos, mesh,
                rules)[0], q)
        else:
            # in-place cache write (of this rank's rows under a mesh),
            # where the reference returns a new cache from
            # dynamic_update_slice; copy_ casts to the cache dtype
            start = (local_rows(k_cache.shape[1], mesh, seq_flat)[0]
                     if seq_flat else 0)
            _write_rows(partition.local(k_cache), start, k_all, cache_pos)
            _write_rows(partition.local(v_cache), start, v_all, cache_pos)
            if s > 1:
                # prefill from row 0 over the fresh k/v (== cache content)
                out = _attend(q, k, v, spec,
                              attn_impl if mesh is None else "xla",
                              causal=True, counter="attn.prefill_flash")
            elif attn_impl == "pallas":
                if seq_flat:
                    kc = _gathered_seq(k_cache, mesh, seq_flat, heads)
                    vc = _gathered_seq(v_cache, mesh, seq_flat, heads)
                else:
                    kc = partition.local(k_cache)[:, :, heads]
                    vc = partition.local(v_cache)[:, :, heads]
                out = da_ops.decode_attention(
                    q[:, 0], kc, vc, cache_pos + s, scale=spec.scale)[:, None]
            elif mesh is not None and rules is not None:
                out = every_head(lambda qq, sp: sharded_cache_attention(
                    qq, k_cache, v_cache, sp, cache_pos, mesh, rules), q)
            else:
                out = _local_cached_attention(q, k_cache, v_cache, spec,
                                              cache_pos)
        new_cache = kv_cache
    out = out.reshape(b, s, spec.q_dim)
    y = torch.einsum("bsh,hd->bsd", out, params["wo"].to(x.dtype))
    y = partition.tp_leave(y, mesh, tp, sp)
    y = partition.constrain(y, ("batch", "seq", "embed_act"))
    if spec.bias:
        bo = params["bo"]
        if sp:
            bo = partition.copy_to_group(bo, mesh, sp)
        y = y + bo.to(x.dtype)
    return y, new_cache


def causal_mask(sq: int, sk: int, offset: int = 0,
                device=None) -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    return (ki <= qi)[None, None, None]


def cross_kv_from_encoder(params, enc: torch.Tensor, spec: AttentionSpec,
                          mesh=None, tp=()):
    """The cross attention's (k, v) [B, Se, Hkv, hd] from the encoder
    states [B, Se, D]: v carries its bias, k has none.  Under tensor
    parallelism over `tp`, this rank's kv heads (wk/wv its columns); the
    encoder states' gradient sums over `tp`."""
    b, se, _ = enc.shape
    enc = partition.tp_enter(enc, mesh, tp)
    k = torch.einsum("bsd,dh->bsh", enc, params["wk"].to(enc.dtype))
    v = torch.einsum("bsd,dh->bsh", enc, params["wv"].to(enc.dtype))
    if spec.bias:
        v = v + params["bv"].to(enc.dtype)
    # -1 heads: a tensor-parallel rank's wk/wv hold its share of them
    return (k.reshape(b, se, -1, spec.head_dim),
            v.reshape(b, se, -1, spec.head_dim))


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def swiglu_mlp(params, x: torch.Tensor, mesh=None, tp=(),
               sp=()) -> torch.Tensor:
    x = partition.tp_enter(x, mesh, tp, sp)
    gate = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
    up = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
    y = partition.tp_leave(y, mesh, tp, sp)
    return partition.constrain(y, ("batch", "seq", "embed_act"))


def gelu_mlp(params, x: torch.Tensor, mesh=None, tp=(),
             sp=()) -> torch.Tensor:
    x = partition.tp_enter(x, mesh, tp, sp)
    h = torch.einsum("bsd,df->bsf", x, params["w_up"].to(x.dtype))
    if "b_up" in params:
        h = h + params["b_up"].to(x.dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"].to(x.dtype))
    y = partition.tp_leave(y, mesh, tp, sp)
    y = partition.constrain(y, ("batch", "seq", "embed_act"))
    if "b_down" in params:
        b_down = params["b_down"]
        if sp:      # added to this rank's rows
            b_down = partition.copy_to_group(b_down, mesh, sp)
        y = y + b_down.to(x.dtype)
    return y


def mlp(params, x: torch.Tensor, kind: str, mesh=None, tp=(),
        sp=()) -> torch.Tensor:
    """The MLP; under tensor parallelism over the mesh axes `tp` the
    params are this rank's hidden units (the up projections' columns, the
    down projection's rows) and the partial outputs sum over `tp`; under
    sequence parallelism (`sp`, as in `attention`) x is this rank's rows,
    gathered before and reduce-scattered after."""
    if kind == "swiglu":
        return swiglu_mlp(params, x, mesh, tp, sp)
    if kind == "gelu":
        return gelu_mlp(params, x, mesh, tp, sp)
    raise ValueError(f"unknown mlp kind {kind!r}")
