"""Kernel building and loading are safe across threads.

The FOS daemon runs chunks in a pool of worker threads, so two workers can
reach a kernel for the first time together.  `nvcc` and the library loader
are stubbed: this machine has neither a CUDA toolkit nor a card.

Also the port's test setup: torch runs this process's share of the
cores (`torch_cpu.py`).
"""
from __future__ import annotations

import sys
import threading

import torch_cpu
from torch_cpu import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

THREADS = 8


def _race(fn, *args):
    """Call fn(*args) from THREADS threads released together, with a short
    switch interval so that they interleave; returns their results."""
    barrier = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def run(i):
        barrier.wait()
        try:
            results[i] = fn(*args)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_concurrent_first_loads_build_and_bind_each_kernel_once(
        monkeypatch, tmp_path):
    builds, binds = [], []

    def fake_build(names):
        builds.append(tuple(names))
        return {n: tmp_path / f"lib{n}.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            self.path = path

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in ("flash_attention", "decode_attention"):
        libs = _race(_build.load, name, binds.append)
        assert all(lib is libs[0] for lib in libs)
    assert builds == [("flash_attention",), ("decode_attention",)]
    assert [lib.path for lib in binds] == [
        str(tmp_path / "libflash_attention.so"),
        str(tmp_path / "libdecode_attention.so")]


def test_concurrent_builds_run_nvcc_once_into_their_own_file(
        monkeypatch, tmp_path):
    """A stand-in nvcc writes its `-o` file and logs each call; eight
    threads building one source together run it once, and the library
    appears whole under its final name."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write(' '.join(sys.argv) + '\\n')\n"
        "time.sleep(0.2)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('library')\n")
    fake.chmod(0o755)
    source = tmp_path / "k.cu"
    source.write_text("// kernel\n")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SOURCES", {"k": source})
    monkeypatch.setattr(_build, "INCLUDE", tmp_path)
    paths = _race(_build.build, ["k"])
    lines = calls.read_text().splitlines()
    assert len(lines) == 1, lines
    # the temporary file is named after the process and the thread
    tmp = lines[0].split(" -o ")[1].split()[0]
    assert tmp.endswith(".tmp") and len(tmp.split(".")) >= 4, tmp
    assert all(p == paths[0] for p in paths)
    assert paths[0]["k"].read_text() == "library"
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_torch_runs_one_core_share_of_threads():
    """One intra-op thread a worker under pytest-xdist's -n 6 on 8 cores,
    every core under a single pytest process (`torch_cpu.threads`)."""
    assert torch.get_num_threads() == torch_cpu.threads()
