"""Causal GQA flash attention, forward ([B, S, H, hd] layout).

Replaces the TPU kernel `repro/kernels/flash_attention/flash_attention.py`
`::flash_attention_bhsd` and its wrapper `ops.py::flash_attention`.  The
Hopper kernels are in `csrc/flash_attention.cu` (CUDA C++, sm_90a), one
route for each input type:

- bf16 runs on the bf16 tensor cores by `wgmma`, its tiles brought by TMA
  from tensor maps over the model's layout (made per call from the
  tensors' strides, 16-byte aligned as `_check_cuda_inputs` requires) by
  a producer warpgroup.  Q.K^T is one bf16 pass; P enters P.V as bf16
  hi + lo in two passes, so the result keeps fp32 accuracy until its
  rounding to bf16, and the bound is 1.5x the FLOP at the bf16
  tensor-core rate.
- fp32 runs on the TF32 tensor cores by `mma.sync`, each operand split
  into two tf32 halves and multiplied in three passes (3xTF32), which
  meets the reference's 2e-5 fp32 tolerance where one TF32 pass cannot;
  it is bound by three TF32 passes over its FLOP.

The design notes are at the top of the source.

`flash_attention` launches the kernel for causal calls on CUDA tensors and
runs `flash_attention_plain` for CPU tensors; on CUDA it never falls back
(a build, tensor-map or launch failure raises).  Non-causal calls go to
the plain version on every device, as the reference wrapper sends them to
its oracle: the kernels are causal by design.  A causal call may also
take a sliding `window` W >= 1: query i then sees keys i - W < j <= i
(q and k from row 0 of one sequence, Sq == Sk).  It runs on its own
fp32 kernel, `flash_window_kernel`, which skips the key tiles below the
band; bf16 has no windowed kernel and refuses one.  The reference
wrapper transposes to [B, H, S, hd] and pads S to the block size; the
kernels read the model's layout through strides and mask the ragged edge
themselves.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None, window: int = 0):
    """The plain torch version: the reference oracle (the wrapper's padding
    and slicing leave the result unchanged).  q: [B,Sq,Hq,hd];
    k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]."""
    return attention_ref(q, k, v, causal=causal, scale=scale, window=window)


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = ([_c_ptr] * 4 + [_c_int] * 7 + [ctypes.c_float]
             + [_c_int] * 10 + [_c_ptr])


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


def _check_window(q, k, causal: bool, window) -> None:
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window {window!r}: a whole number of keys >= 1, "
                         f"or 0 for none")
    if window and not causal:
        raise ValueError("a window bounds causal attention only")
    if window and q.shape[1] != k.shape[1]:
        raise ValueError(f"a window needs q and k from row 0 of one "
                         f"sequence (Sq == Sk); got {q.shape[1]} and "
                         f"{k.shape[1]}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int = 0):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.
    Query i sees keys j <= i, and with `window` W > 0 (causal, Sq == Sk,
    fp32 on CUDA) only those with j > i - W; fp32 accumulation.  Raises
    under autograd on the kernel route (causal), on every device, as the
    reference does."""
    _check_window(q, k, causal, window)
    if causal:
        _build.require_no_grad("flash_attention", "attn_impl", q, k, v)
    if not causal or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    if window and q.dtype != torch.float32:
        raise TypeError(f"a window runs on the fp32 kernel only; got "
                        f"{q.dtype}")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, hq, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, sq, sk, hq, hq // hkv, hd, float(scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], window,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", rc)
    flash_attention.launches += 1
    flash_attention.window_launches += bool(window)
    return out


flash_attention.launches = 0   # kernel launches since the last reset
flash_attention.window_launches = 0     # of them, `flash_window_kernel`'s
