"""Module builders for the FOS runtime: the accelerator zoo.

Mirrors `repro/core/zoo.py`, the FOS analogues of the paper's case-study
accelerators:
  - mandelbrot : compute-bound fractal iteration (paper section 5.5)
  - sobel      : memory-bound 3x3 stencil (paper section 5.5)
  - matmul     : generic dense kernel (spector-style)
  - lm_forward : an LM forward step from the model zoo

Each builder(slot, footprint) -> ModuleProgram.  As the reference's
builders read their mesh, these read the slot: its devices
(`slot.run_devices`) and its data axis, over which every input is split
by rows (`input_pspecs`, the reference's `P(axis, None)`); weights are
replicated on every device.  On a slot of several devices mandelbrot,
matmul and lm-forward compute each row from its own row alone; sobel's
3x3 stencil needs a row of context from each neighbouring part, which
`halo=1` gives it.  None of the first three
is a Pallas kernel in the reference, so each is plain PyTorch here, written
so that it computes what the reference computes on the CPU:
  - mandelbrot writes its update with `addcmul`: XLA's CPU backend
    contracts `zr*zr - zi*zi + re` into `fma(zr, zr, -(zi*zi)) + re` and
    `2*zr*zi + im` into `fma(2*zr, zi, im)`, and the escape counts of a
    chaotic iteration follow that rounding (a plain transcription gets
    some of them wrong by many iterations);
  - sobel sums shifted fp32 taps of a zero-padded image instead of calling
    a convolution, which cuDNN would run in TF32 on the card under
    PyTorch's default `torch.backends.cudnn.allow_tf32`.
`lm_forward` runs the model zoo's forward with `attn_impl="pallas"`, so
its attention is the hand-written flash kernel on a CUDA slot.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.module import ModuleProgram, TensorSpec


def _data_axis(slot) -> str:
    return "data" if slot is None else slot.axes[0]


def _rows(slot, n_dev_rows: int) -> None:
    """Each device gets an equal share of the rows (the reference's
    sharding requires it too).  `slot=None` builds for no slot (the
    program alone)."""
    n_dev = 1 if slot is None else len(slot.run_devices)
    if n_dev_rows % n_dev:
        raise ValueError(f"{n_dev_rows} rows do not split over the slot's "
                         f"{n_dev} devices")


def build_mandelbrot(slot, footprint: int, *, size: int = 256,
                     iters: int = 256) -> ModuleProgram:
    """Compute-bound: escape-time iteration over an image tile."""

    def fn(_, grid_re, grid_im):
        zr = torch.zeros_like(grid_re)
        zi = torch.zeros_like(grid_im)
        count = torch.zeros(grid_re.shape, dtype=torch.int32,
                            device=grid_re.device)
        for _ in range(iters):
            zr2 = torch.addcmul(-(zi * zi), zr, zr) + grid_re
            zi2 = torch.addcmul(grid_im, 2 * zr, zi)
            inside = zr2 * zr2 + zi2 * zi2 < 4.0
            zr = torch.where(inside, zr2, zr)
            zi = torch.where(inside, zi2, zi)
            count += inside
        return count

    shape = (size, size)
    _rows(slot, size)
    spec = (_data_axis(slot), None)
    return ModuleProgram(
        fn=fn,
        abstract_weights=None,
        abstract_inputs=(TensorSpec(shape, torch.float32),
                         TensorSpec(shape, torch.float32)),
        init_weights=None,
        input_pspecs=(spec, spec),
    )


def _sobel(img: torch.Tensor) -> torch.Tensor:
    """|(gx, gy)| of the 3x3 Sobel filters over the zero-padded image, as
    XLA's SAME-padded cross-correlation with kx = [[-1,0,1],[-2,0,2],
    [-1,0,1]] and ky = kx.T."""
    h, w = img.shape
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))

    def tap(r, c):
        return p[r:r + h, c:c + w]

    gx = (tap(0, 2) - tap(0, 0)) + 2 * (tap(1, 2) - tap(1, 0)) \
        + (tap(2, 2) - tap(2, 0))
    gy = (tap(2, 0) - tap(0, 0)) + 2 * (tap(2, 1) - tap(0, 1)) \
        + (tap(2, 2) - tap(0, 2))
    return torch.sqrt(gx * gx + gy * gy)


def build_sobel(slot, footprint: int, *, size: int = 1024) -> ModuleProgram:
    """Memory-bound 3x3 stencil over an image tile."""
    _rows(slot, size)
    return ModuleProgram(
        fn=lambda _, img: _sobel(img), abstract_weights=None,
        abstract_inputs=(TensorSpec((size, size), torch.float32),),
        init_weights=None, input_pspecs=((_data_axis(slot), None),),
        halo=1)


def build_matmul(slot, footprint: int, *, m: int = 512, k: int = 512,
                 n: int = 512) -> ModuleProgram:
    """Dense kernel with weights (vadd/spector stand-in)."""

    def fn(w, x):
        return torch.relu(x @ w["a"] + w["b"])

    def init(gen):
        return {"a": torch.randn((k, n), generator=gen) * 0.02,
                "b": torch.zeros((n,))}

    _rows(slot, m)
    return ModuleProgram(
        fn=fn,
        abstract_weights={"a": TensorSpec((k, n), torch.float32),
                          "b": TensorSpec((n,), torch.float32)},
        abstract_inputs=(TensorSpec((m, k), torch.float32),),
        init_weights=init, input_pspecs=((_data_axis(slot), None),))


def build_lm_forward(slot, footprint: int, *, arch: str = "llama3.2-3b",
                     batch: int = 8, seq: int = 64,
                     reduced: bool = True) -> ModuleProgram:
    """Teacher-forced LM forward (module-zoo integration): the logits of
    the last position, [batch, vocab].  `reduced=False` builds the full
    width of `arch`.  The config's dtypes are the reference's (params
    fp32, compute and cache bf16)."""
    from repro_torch import configs
    from repro_torch.models import api, stack

    cfg = dataclasses.replace(configs.get(arch, reduced=reduced),
                              attn_impl="pallas")

    def fn(params, tokens):
        h, _ = stack.forward(params, cfg, {"tokens": tokens})
        # the unembedding's GEMM always over `batch` rows (a part's rows
        # padded with zeros): the kernel, and with it each row's order of
        # summation, follows the row count, so a row's logits are the same
        # on a slot of any width; on one device it is the one GEMM
        last = h[:, -1:]
        pad = batch - last.shape[0]
        if pad:
            last = torch.cat([last, last.new_zeros((pad,) + last.shape[1:])])
        return stack.unembed(params, cfg, last)[:tokens.shape[0], 0]

    _rows(slot, batch)
    return ModuleProgram(
        fn=fn,
        abstract_weights=api.unflatten(
            (path, TensorSpec(spec.shape, cfg.param_dtype))
            for path, spec in api.flatten(api.param_table(cfg))),
        abstract_inputs=(TensorSpec((batch, seq), torch.int32),),
        init_weights=lambda gen: api.init_params(cfg, gen),
        input_pspecs=((_data_axis(slot), None),))
