"""Decode attention: one query token per (batch, q-head) against the cache.

Replaces the TPU kernel `repro/kernels/decode_attention/decode_attention.py`
`::decode_attention_bhd` and its wrapper `ops.py::decode_attention`.  The
Hopper kernel is `csrc/decode_attention.cu` (CUDA C++, sm_90a).  It is bound
by device-memory bytes (each valid K/V row is read once for g query heads);
its design note is at the top of the source.  Each (batch, kv head) is one
thread-block cluster of `split_count(...)` CTAs, each streaming the rows
`split_rows(...)` gives it, merged through distributed shared memory; at
16 q heads a kv head, two such clusters, each of 8 of the q heads.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain` only for CPU tensors.  The reference wrapper
transposes the cache to [B, Hkv, S, hd] and pads S; the kernel reads the
model's [B, S, Hkv, hd] cache in place instead, and masks `>= length`
itself, so neither copy exists here.  The kernel reads `length` from
device memory: a one-element int32 tensor (a decode step's position,
which a replayed CUDA graph advances without a host read), or an int,
which the wrapper puts in such a tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)
CTA_GROUP = 8       # q heads per kv head held in one CTA's registers
MAX_GROUP = 16      # q heads per kv head: up to CTA_GROUP, or two CTAs'
MAX_SPLITS = 8      # CTAs of one cluster: the portable cluster size
CTAS_PER_SM = 2     # the split count aims at this many CTAs on each SM


def split_count(batch: int, hkv: int, sms: int, g: int = 1) -> int:
    """CTAs (one cluster) that share the rows of each (batch, kv head, CTA
    of its g q heads): as many as put about CTAS_PER_SM CTAs on every SM,
    at most MAX_SPLITS, and 1 once those clusters alone fill the card.  It
    depends on neither the length nor the position, so the grid is the
    same at every decode step."""
    pairs = batch * hkv * -(-g // CTA_GROUP)
    if pairs >= sms:
        return 1
    return min(MAX_SPLITS, -(-CTAS_PER_SM * sms // pairs))


def split_rows(length: int, splits: int) -> list[tuple[int, int]]:
    """The rows [start, end) each CTA of a cluster streams, as the kernel
    computes them: ceil(length / splits) each in order, the last shorter or
    empty."""
    share = -(-length // splits)
    return [(min(length, r * share), min(length, (r + 1) * share))
            for r in range(splits)]


def decode_attention_plain(q, k_cache, v_cache, length: int, *,
                           scale: float):
    """The plain torch version: the reference oracle plus its wrapper's
    cast of the cache to q's dtype.  q: [B,Hq,hd]; caches [B,S,Hkv,hd]."""
    return decode_attention_ref(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                length, scale=scale)


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = ([_c_ptr] * 4 + [_c_int] * 5 + [_c_ptr] + [_c_int] * 2
             + [ctypes.c_float] + [_c_int] * 6 + [_c_ptr])


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention.argtypes = _ARGTYPES
    lib.decode_attention.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("decode_attention", _bind)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_cuda_inputs(q, k, v, length):
    b, hq, hd = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hq % hkv or (hq // hkv > CTA_GROUP and hq // hkv != MAX_GROUP):
        raise ValueError(f"q heads {hq} must be a multiple of kv heads "
                         f"{hkv}, at most {CTA_GROUP} per kv head or "
                         f"{MAX_GROUP} (two CTAs of {CTA_GROUP})")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype} not supported (fp32, bf16)")
    if not (k.device == v.device == q.device):
        raise ValueError("q and the caches must be on one device")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if isinstance(length, torch.Tensor):
        # read by the kernel, which clamps it to [1, S]
        if length.dtype != torch.int32 or length.numel() != 1 \
                or length.device != q.device:
            raise ValueError("a device length is one int32 on q's device")
    elif not 1 <= length <= k.shape[1]:
        raise ValueError(f"length {length} outside [1, {k.shape[1]}]")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16 or max(t.stride()) >= 2 ** 31:
            raise ValueError("tensors need a unit last stride, 16-byte "
                             "aligned rows and int32 strides")


def decode_attention(q, k_cache, v_cache, length, *, scale: float):
    """q: [B,Hq,hd]; caches [B,S,Hkv,hd]; length: valid prefix length, an
    int or a one-element int32 tensor on q's device (which the kernel
    clamps to [1, S]).  Returns [B,Hq,hd] in q's dtype; fp32
    accumulation.  Raises under autograd, on every device, as the
    reference does."""
    _build.require_no_grad("decode_attention", "attn_impl", q, k_cache,
                           v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, int(length),
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    # the reference casts the cache to q's dtype; the serving path keeps the
    # cache in q's dtype, so this copy does not happen there
    k = k_cache if k_cache.dtype == q.dtype else k_cache.to(q.dtype)
    v = v_cache if v_cache.dtype == q.dtype else v_cache.to(q.dtype)
    _check_cuda_inputs(q, k, v, length)
    if not isinstance(length, torch.Tensor):
        length = torch.full((1,), length, dtype=torch.int32, device=q.device)
    b, hq, hd = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    splits = split_count(b, hkv, _sm_count(q.device.index), hq // hkv)
    lib = _lib()
    rc = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, hkv, hq // hkv, hd, length.data_ptr(),
        k.shape[1], splits, float(scale), *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0   # kernel launches since the last reset
