"""Causal GQA flash attention, forward ([B, S, H, hd] layout).

Replaces the TPU kernel `repro/kernels/flash_attention/flash_attention.py`
`::flash_attention_bhsd` and its wrapper `ops.py::flash_attention`.  The
Hopper kernel is `csrc/flash_attention.cu` (CUDA C++, sm_90a).  Both of its
products run on the TF32 tensor cores (`mma.sync`); fp32 operands are split
into two tf32 halves and multiplied in three passes (3xTF32), which meets
the reference's 2e-5 fp32 tolerance where one TF32 pass cannot, so in fp32
it is bound by three TF32 passes over its FLOP (in bf16 by the bf16
tensor-core rate, which this route does not approach).  Its design note is
at the top of the source.

`flash_attention` launches the kernel for causal calls on CUDA tensors and
runs `flash_attention_plain` for CPU tensors.  Non-causal calls go to the
plain version on every device, as the reference wrapper sends them to its
oracle: the kernel is causal by design.  The reference wrapper transposes
to [B, H, S, hd] and pads S to the block size; the kernel reads the model's
layout through strides and masks the ragged edge itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """The plain torch version: the reference oracle (the wrapper's padding
    and slicing leave the result unchanged).  q: [B,Sq,Hq,hd];
    k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]."""
    return attention_ref(q, k, v, causal=causal, scale=scale)


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = ([_c_ptr] * 4 + [_c_int] * 7 + [ctypes.c_float]
             + [_c_int] * 9 + [_c_ptr])


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = _ARGTYPES
    lib.flash_attention.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _bind)


def _check_cuda_inputs(q, k, v):
    b, _, hq, hd = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        f"fp32, bf16 for all three")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16 or max(t.stride()) >= 2 ** 31:
            raise ValueError("tensors need a unit last stride, 16-byte "
                             "aligned rows and int32 strides")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.
    Query i sees keys j <= i; fp32 accumulation.  Raises under autograd on
    the kernel route (causal), on every device, as the reference does."""
    if causal:
        _build.require_no_grad("flash_attention", "attn_impl", q, k, v)
    if not causal or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, sq, sk, hq, hq // hkv, hd, float(scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", rc)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0   # kernel launches since the last reset
