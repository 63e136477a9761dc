"""Module builders for the FOS runtime: the accelerator zoo.

Mirrors `repro/core/zoo.py`, the FOS analogues of the paper's case-study
accelerators:
  - mandelbrot : compute-bound fractal iteration (paper section 5.5)
  - sobel      : memory-bound 3x3 stencil (paper section 5.5)
  - matmul     : generic dense kernel (spector-style)
  - lm_forward : an LM forward step from the model zoo

Each builder(slot, footprint) -> ModuleProgram.  None of the first three
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
    return ModuleProgram(
        fn=fn,
        abstract_weights=None,
        abstract_inputs=(TensorSpec(shape, torch.float32),
                         TensorSpec(shape, torch.float32)),
        init_weights=None,
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
    return ModuleProgram(
        fn=lambda _, img: _sobel(img), abstract_weights=None,
        abstract_inputs=(TensorSpec((size, size), torch.float32),),
        init_weights=None)


def build_matmul(slot, footprint: int, *, m: int = 512, k: int = 512,
                 n: int = 512) -> ModuleProgram:
    """Dense kernel with weights (vadd/spector stand-in)."""

    def fn(w, x):
        return torch.relu(x @ w["a"] + w["b"])

    def init(gen):
        return {"a": torch.randn((k, n), generator=gen) * 0.02,
                "b": torch.zeros((n,))}

    return ModuleProgram(
        fn=fn,
        abstract_weights={"a": TensorSpec((k, n), torch.float32),
                          "b": TensorSpec((n,), torch.float32)},
        abstract_inputs=(TensorSpec((m, k), torch.float32),),
        init_weights=init)


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
        return stack.unembed(params, cfg, h[:, -1:])[:, 0]

    return ModuleProgram(
        fn=fn,
        abstract_weights=api.unflatten(
            (path, TensorSpec(spec.shape, cfg.param_dtype))
            for path, spec in api.flatten(api.param_table(cfg))),
        abstract_inputs=(TensorSpec((batch, seq), torch.int32),),
        init_weights=lambda gen: api.init_params(cfg, gen))
