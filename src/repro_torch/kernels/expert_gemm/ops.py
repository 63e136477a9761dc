"""The MoE layer's grouped expert product over occupied row tiles.

Replaces no TPU kernel: the reference's expert product is XLA's batched
matmul over every capacity slot (`repro/models/moe.py::_expert_ffn`).
The served prefill fills each expert's slots from the front
(`models/moe.py::_sorted_dispatch`), so slots [0, count_e) hold its kept
pairs and the rest are zero rows; `expert_gemm` computes only the
`ROW_TILE`-row tiles that hold an occupied slot and writes zeros past
them.  The Hopper kernel is `csrc/expert_gemm.cu` (CUDA C++, sm_90a), fp32
FFMA with one accumulator an output summed over k in ascending order, as
a SIMT GEMM without split-K sums.  It is bound by FFMA at 67 TFLOP/s over
the FLOPs the function needs, 2 * K * N * sum_e count_e; the rows of whole
tiles it computes past the counts (`computed_rows`) are its tile waste.

`expert_gemm` launches the kernel for CUDA tensors and runs
`expert_gemm_plain` (torch.bmm, then the rows past the counts set to 0)
only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ROW_TILE = 64       # the rows a block computes or skips (csrc: kBM)
_MAX_GRID_YZ = 65535


def expert_gemm_plain(x, w, counts):
    """x: [E, C, K], w: [E, K, N], counts: [E] -> [E, C, N]: x @ w with
    the rows at or past each expert's count set to 0."""
    y = torch.bmm(x, w)
    rows = torch.arange(x.shape[1], device=x.device)
    return y.masked_fill_(rows[None, :, None] >= counts[:, None, None], 0.0)


def computed_rows(counts):
    """The rows the kernel computes: each expert's occupied slots rounded
    up to whole row tiles (0-d int64)."""
    return ((counts.long() + ROW_TILE - 1) // ROW_TILE * ROW_TILE).sum()


_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p


def _bind(lib: ctypes.CDLL) -> None:
    lib.expert_gemm.argtypes = [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr]
    lib.expert_gemm.restype = ctypes.c_int
    lib.expert_gemm_row_tile.restype = ctypes.c_int
    if lib.expert_gemm_row_tile() != ROW_TILE:
        raise RuntimeError(f"expert_gemm: the kernel's row tile "
                           f"{lib.expert_gemm_row_tile()} is not ROW_TILE "
                           f"{ROW_TILE}")


def _lib() -> ctypes.CDLL:
    return _build.load("expert_gemm", _bind)


def _check_cuda_inputs(x, w, counts):
    """Raise on what the kernel does not take."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are "
                         f"not [E, C, K] and [E, K, N]")
    if counts.shape != (x.shape[0],) or counts.dtype != torch.int32:
        raise ValueError(f"counts {tuple(counts.shape)} {counts.dtype}: "
                         f"need [{x.shape[0]}] int32")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"dtypes {x.dtype}/{w.dtype}: the kernel is fp32")
    if w.device != x.device or counts.device != x.device:
        raise ValueError("all inputs must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if w.shape[2] % 4 or w.data_ptr() % 16:
        raise ValueError(f"w {tuple(w.shape)}: the kernel reads its rows "
                         f"by 16 bytes (N % 4 == 0, 16-byte aligned)")
    e, c, _ = x.shape
    if e > _MAX_GRID_YZ or -(-c // ROW_TILE) > _MAX_GRID_YZ \
            or max(*x.shape, *w.shape) >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}: too "
                         f"large for the grid or int32 sizes")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("expert_gemm: the kernel has no backward; inputs "
                           "that require grad need torch.bmm")


def expert_gemm(x, w, counts):
    """x: [E, C, K], w: [E, K, N] fp32; counts: [E] int32, each expert's
    occupied slots (a prefix of its C; rows past it are zero in x).
    Returns y [E, C, N] fp32: x @ w on the row tiles that hold an occupied
    slot, 0 on every row at or past the count."""
    if x.device.type == "cpu":
        return expert_gemm_plain(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"expert_gemm: unsupported device {x.device}")
    _check_cuda_inputs(x, w, counts)
    e, c, k = x.shape
    n = w.shape[2]
    y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.expert_gemm(x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                         y.data_ptr(), e, c, k, n,
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "expert_gemm", rc)
    expert_gemm.launches += 1
    return y


expert_gemm.launches = 0    # kernel launches since the last reset
