"""repro_torch: the FOS model zoo and serving path in PyTorch for NVIDIA Hopper.

The JAX package `repro` is the reference; this package mirrors its layout
(`configs`, `models`, `kernels`, `launch`) so each counterpart is easy to
find.  It imports torch and numpy only, never jax or anything of `repro`.

Entry points run on `cuda` unless the caller passes `device="cpu"`.  The
attention kernels are hand-written CUDA C++ for `sm_90a`, built with nvcc
at first use (`repro_torch.kernels._build`); on CPU tensors their wrappers
run the plain PyTorch version instead.
"""
