"""Mamba2 SSD chunked scan ([B, L, H, P] layout).

Replaces the TPU kernel `repro/kernels/ssd_scan/ssd_scan.py::ssd_pallas`
and its wrapper `ops.py::ssd`.  The Hopper kernel is `csrc/ssd_scan.cu`
(CUDA C++, sm_90a).  It is bound by fp32 operations (no TF32, to meet the
reference's fp32 tolerances); its design note is at the top of the source.
One call enqueues four kernels (C.B^T, chunk states, state passing, chunk
scan) that meet in scratch the wrapper allocates (`scratch_shapes`).

`ssd(impl="pallas")` launches the kernel for CUDA tensors and runs
`ssd_plain` only for CPU tensors; `impl="xla"` is the plain version on any
device.  The reference pads L to a multiple of the chunk with dt = 0 and
transposes every input, then folds `initial_state` in afterwards by
linearity; the kernel reads the inputs in place through strides, reads a
ragged last chunk as zero rows with dt = 0, and seeds its state from
`initial_state`, so none of those copies or the fold-in exists here.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CHUNKS = (16, 32, 64, 128)
HEAD_DIMS = (16, 32, 64)          # P
STATE_DIMS = (16, 32, 64, 128)    # N
_MAX_GRID_YZ = 65535


def ssd_plain(x, dt, a, b, c, *, chunk: int, initial_state=None):
    """The plain torch version: the reference wrapper's padding (dt = 0 is
    an identity step) around the oracle.  Returns (y [B,L,H,P] f32,
    final_state [B,H,P,N] f32)."""
    seqlen = x.shape[1]
    pad = (-seqlen) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    y, final = ssd_ref(x, dt, a, b, c, chunk=chunk,
                       initial_state=initial_state)
    return y[:, :seqlen], final


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_c_ptr] * 11 + [_c_int] * 20 + [_c_ptr]


def scratch_shapes(bsz: int, seqlen: int, heads: int, groups: int, p: int,
                   n: int, chunk: int) -> dict[str, tuple[int, ...]]:
    """The fp32 scratch one kernel call needs, with nc = ceil(L / chunk):
    C.B^T per (batch, chunk, group); each chunk's state contribution,
    overwritten in place by the state entering that chunk; and each chunk's
    decay exp(cum_last)."""
    nc = -(-seqlen // chunk)
    return {"cb": (bsz, nc, groups, chunk, chunk),
            "states": (bsz, heads, nc, p, n),
            "decay": (bsz, heads, nc)}


def _bind(lib: ctypes.CDLL) -> None:
    lib.ssd_scan.argtypes = _ARGTYPES
    lib.ssd_scan.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("ssd_scan", _bind)


def _check_cuda_inputs(x, dt, a, b, c, chunk: int, initial_state):
    """Raise on what the kernel does not take."""
    bsz, seqlen, h, p = x.shape
    if b.shape != c.shape or b.dim() != 4 or b.shape[:2] != (bsz, seqlen):
        raise ValueError(f"b/c shapes {tuple(b.shape)}/{tuple(c.shape)} do "
                         f"not match x {tuple(x.shape)}")
    g, n = b.shape[2], b.shape[3]
    if dt.shape != (bsz, seqlen, h) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if chunk not in CHUNKS or p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"chunk {chunk}, P {p}, N {n}: the kernel takes "
                         f"chunk in {CHUNKS}, P in {HEAD_DIMS}, N in "
                         f"{STATE_DIMS}")
    if seqlen < 1:
        raise ValueError("empty sequence")
    # grid rows: the chunk-scan kernel runs chunk / min(chunk, 64) CTAs per
    # chunk, the C.B^T kernel one per (batch, group)
    if -(-seqlen // chunk) * (chunk // min(chunk, 64)) > _MAX_GRID_YZ \
            or bsz * g > _MAX_GRID_YZ:
        raise ValueError(f"sequence {seqlen} or batch {bsz} too long for "
                         f"the kernel's grid")
    if not (x.dtype == b.dtype == c.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtypes {x.dtype}/{b.dtype}/{c.dtype}: need one of "
                        f"fp32, bf16 for x, b and c")
    tensors = [x, dt, a, b, c]
    if initial_state is not None:
        if initial_state.shape != (bsz, h, p, n):
            raise ValueError(f"initial_state {tuple(initial_state.shape)} "
                             f"!= {(bsz, h, p, n)}")
        tensors.append(initial_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    vec = 16 // x.element_size()
    for t in (x, b, c):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16 or max(t.stride()) >= 2 ** 31:
            raise ValueError("x, b and c need a unit last stride, 16-byte "
                             "aligned rows and int32 strides")
    if max(dt.stride()) >= 2 ** 31:
        raise ValueError("dt needs int32 strides")


def ssd(x, dt, a, b, c, *, chunk: int = 128, impl: str = "xla",
        initial_state=None):
    """x: [B,L,H,P]; dt: [B,L,H] (post-softplus); a: [H] (negative);
    b, c: [B,L,G,N]; initial_state: [B,H,P,N] or None (zeros).
    Returns (y [B,L,H,P] f32, final_state [B,H,P,N] f32).  Any L: a ragged
    last chunk is an identity-padded one, as in the reference.  The kernel
    route raises under autograd, on every device, as the reference does."""
    if impl == "pallas":
        _build.require_no_grad("ssd", "ssd_impl", x, dt, a, b, c,
                               initial_state)
    if impl == "xla" or (impl == "pallas" and x.device.type == "cpu"):
        return ssd_plain(x, dt, a, b, c, chunk=chunk,
                         initial_state=initial_state)
    if impl != "pallas":
        raise ValueError(f"unknown ssd impl {impl!r}")
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    dt = dt.float()
    a = a.float().contiguous()
    if initial_state is not None:
        initial_state = initial_state.float().contiguous()
    _check_cuda_inputs(x, dt, a, b, c, chunk, initial_state)
    bsz, seqlen, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty((bsz, seqlen, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    scratch = {k: torch.empty(shape, dtype=torch.float32, device=x.device)
               for k, shape in scratch_shapes(bsz, seqlen, h, g, p, n,
                                              chunk).items()}
    lib = _lib()
    rc = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch["cb"].data_ptr(),
        scratch["states"].data_ptr(), scratch["decay"].data_ptr(),
        _DTYPE_CODE[x.dtype], bsz, seqlen,
        h, g, p, n, chunk, *x.stride()[:3], *dt.stride(), *b.stride()[:3],
        *c.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "ssd_scan", rc)
    ssd.launches += 1
    return y, state


ssd.launches = 0   # kernel calls since the last reset (four device kernels each)
