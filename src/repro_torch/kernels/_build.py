"""Build the CUDA kernels with nvcc and load them with ctypes.

Each kernel is one `.cu` source with a plain C interface under its
package's `csrc/`.  At first use every source is compiled for `sm_90a`
into a shared library under `<repo>/build/kernels/` (one nvcc process per
source, all started together), named by a digest of the source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is not.  Nothing is built or loaded when a module is imported.

Building and loading are safe across threads (the FOS daemon runs chunks
in a pool of workers): one lock serialises `build` and `load`, so two
workers that first reach a kernel together run nvcc once and neither sees
a library before it is whole and bound.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
SOURCES = {
    "decode_attention":
        _KERNELS / "decode_attention" / "csrc" / "decode_attention.cu",
    "flash_attention":
        _KERNELS / "flash_attention" / "csrc" / "flash_attention.cu",
    "ssd_scan": _KERNELS / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "expert_gemm": _KERNELS / "expert_gemm" / "csrc" / "expert_gemm.cu",
}
INCLUDE = _KERNELS / "csrc"
_LOCK = threading.RLock()
_LIBS: dict[str, ctypes.CDLL] = {}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{INCLUDE}"]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for hdr in sorted(INCLUDE.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel.  The compiler's report (-Xptxas -v: registers, shared memory,
    spills) is kept beside each library as `.log`.  Raises on any failure.
    Another process may build the same library at the same time: each
    writes its own temporary file and renames it into place."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: library_path(n) for n in names}
        procs = {}
        for n, lib in todo.items():
            if lib.exists():
                continue
            tmp = lib.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            procs[n] = (subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        errors = []
        for n, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed for {n} "
                              f"(rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        return todo


def load(name: str, bind=None) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed.  `bind(lib)` (the
    caller's argtypes and restypes) runs once, before any caller gets the
    library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            if bind is not None:
                bind(lib)
            _LIBS[name] = lib
        return lib


def require_no_grad(name: str, knob: str, *tensors) -> None:
    """Raise if autograd would record through the kernel route `name`.

    The kernels are forward only and launched through ctypes, so their
    outputs carry no `grad_fn`: a caller in grad mode whose inputs require
    grad would get no gradient from them, and no error.  The reference
    raises there too (it has no VJP for `pallas_call`), on every device,
    so this does as well; the plain route (`knob="xla"`) differentiates."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel route has no backward; inputs that require "
            f"grad need the plain route ({knob}=\"xla\") or torch.no_grad()")


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        msg = fn(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
