#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check makes the exit code non-zero and keeps
the final `{"ok": true, ...}` line from printing:
  1. report the card (nvidia-smi name and power limit), turn TF32 off for
     matmuls and cuDNN, build the CUDA kernels from the sources (timed);
     fail on a register spill in a main-path instantiation; report the
     registers and CTAs an SM of the MHA decode instances (G=1 at hd=64
     and hd=96); count the HMMA (tensor-core) instructions of the hd=128
     and hd=96 flash kernels where the toolkit has cuobjdump;
  2. hold each kernel against its plain PyTorch version on the card: the
     reference test cases plus the full-width llama3.2-3b and mamba2-780m
     shapes, each in fp32 (tolerance 2e-5; SSD state 1e-4) and bf16 (2e-2;
     SSD state 5e-2); decode lengths whose split-KV shares run empty or
     ragged (1, 7, 9, 131, 1033 rows, the full cache, B=1); flash lengths
     below one mma tile and ragged against its tiles (S = 1, 7, 1000,
     1040), hd=16 at S=1024 and B=1 at full width, and inputs x3 (a
     peaky softmax) held against fp64 at twice fp32's own error; the
     full-width SSD shape also at the decay and step ranges of the model's
     init, at L=4096 (32 chunks of state passing), and continued from a
     carried state; decode at jamba's and qwen3-moe's groupings (32 q
     heads on 8 and on 4 kv heads) at lengths 1040 and 1, flash at both
     at S=1024, and the SSD at jamba's shape (128 heads, d_state 16) at
     its init's decay and step ranges; MHA at whisper's 20 heads of 64
     and phi-3-vision's 32 of 96: decode at lengths 1, 7, 131, 1040 and
     1056 and B=1 (hd=96), flash at S=1024, and at hd=96 also S = 1, 7,
     1000, 1040, B=1 and inputs x3 against fp64;
  3. serve llama3.2-3b at full width (B=4, 1024-token prompt, 32 new
     tokens, attn_impl="pallas"): the decode kernel must launch exactly
     28 layers x 31 steps = 868 times and no other kernel; a plain ("xla")
     rerun with the same weights, teacher-forced on the served tokens, must
     match every step's logits at atol = rtol = 1e-3 (fp32 over 28 layers,
     sums in another order);
  4. the llama3.2-3b cache-free forward at full width (B=4, S=1024):
     exactly 28 flash kernel launches, final hidden state within 1e-3 of
     the plain forward;
  5. serve mamba2-780m at full width (the same B, prompt and new tokens;
     serving runs the SSD kernel on the card): exactly 48 SSD-scan
     launches, all in prefill (the decode step is plain torch, as in the
     reference), no attention kernel, and every step's logits within 1e-3
     of the plain rerun;
  6. the mamba2-780m forward at full width: 48 SSD-scan launches, hidden
     state within 1e-3 of the plain forward;
  7. times with CUDA events (median of >= 20, after warm-up, L2 flushed
     before each run): each kernel, its plain version and one PyTorch call
     computing the same function where there is one (the `library_ms`
     yardstick, used nowhere in the port), their lower bounds on the card
     (the bytes over the memory rate, or the FLOP at the tensor-core rate
     of the inputs' type: 3xTF32 for fp32, bf16's own for bf16),
     each kernel's device-only time (torch.profiler: its kernels' self
     device time over the calls, and how many device kernels one call
     enqueues; the flash kernel also in bf16), prefill and decode of both
     models, the llama3.2-3b forward on the flash kernel and with plain
     attention, and a torch.profiler breakdown;
  8. the FOS runtime on the card (run after phase 6; then 9-12 and 7):
     (a) `serve_daemon` as the reference's (mandelbrot and sobel tenants on
     one slot and its stream): 14 chunks, every output equal to a direct
     `run_placement` on the card, the mandelbrot counts within 1% of
     pixels of the CPU's (the iteration is chaotic and the card rounds
     otherwise); (b) a deterministic preemption (8 low-priority chunks
     on a preemptive 1-slot shell, then a priority-5 request): >= 1
     preemption, every chunk once and right; (c) the contract run: admitted +
     degraded + rejected = 6, each rejected future raising
     AdmissionRejected; (d) the `lm-forward` module at the full width of
     llama3.2-3b (bf16 compute, as the reference config) through the
     daemon, 3 chunks: exactly 28 x (3 + 1 warm-up) = 112 flash kernel
     launches and no other kernel, one reconfiguration and two reuses, a
     second placement a cache hit, logits within 5e-2 relative L2 of the
     plain path on the same weights; then the chunk time of each zoo
     module on the card (CUDA events on the slot's stream, median of 5),
     a torch.profiler breakdown of one lm-forward and one mandelbrot
     chunk, and the flash kernel alone at the module's attention shape
     beside SDPA in bf16.  (a) writes the flight recorder's Chrome trace
     (`trace_out`), which must parse and count the daemon's 14 chunks and
     its preemptions; (b) runs with a recorder attached, whose counts must
     be the daemon's;
  9. jamba-v0.1-52b cut to one super-block (n_layers=8: 1 attention, 7
     mamba, 4 MoE and 4 dense FFN sub-layers; 13.27 B params, 53.1 GB in
     fp32) at full width, and
 10. qwen3-moe-30b-a3b cut to 16 of its 48 layers (10.59 B params) at full
     width: served as phases 3 and 5 (the kernel path, MoE layers on the
     gather route): exactly 31 decode and 7 SSD launches (jamba) / 496
     decode launches (qwen3-moe) and no other kernel, every step's logits
     within 1e-3 of a teacher-forced plain rerun (plain attention and SSD,
     the one-hot MoE oracle), with the (token, expert) routes that differ
     between the two runs printed per MoE sub-layer; the forward (1 flash
     and 7 SSD / 16 flash launches, hidden state within 1e-3); one MoE
     layer alone at T=4096 and T=4: the same experts and the same dropped
     pairs on both routes, outputs within 2e-5, aux within 1e-6; and their
     times (prefill, decode step, the MoE layer, a profile of one prefill
     naming router, dispatch, experts and combine).  Each frees its params
     before the next phase; every phase prints its wall time and
     max_memory_allocated.
 11. whisper-large-v3 at full width and depth (32 encoder and 32 decoder
     layers, 1.607 B params, 6.43 GB in fp32; 1536 stub frames), and
 12. phi-3-vision-4.2b at full width and depth (32 layers, 3.822 B params,
     15.29 GB; 576 stub patches spliced over the prompt's first
     positions): served as phase 3 (exactly 32 x 31 = 992 decode
     launches, no other kernel; cross attention and the encoder are plain,
     as the reference's), every step's logits within 1e-3 of a
     teacher-forced plain rerun; the forward (exactly 32 flash launches,
     hidden state within 1e-3); prefill and decode-step times and a
     profile of one prefill, whisper's naming its encoder's and its cross
     attention's shares.
Each of phases 3-6 and 8-12 sets every launch count to 0 just before it
drives a path and reads the counts just after.  Phase 7 (run last) also
times the decode kernel at jamba's, qwen3-moe's, whisper's and
phi-3-vision's heads, the flash kernel at their forward shapes and the
SSD kernel at jamba's shape.  Then the `kernels` JSON line, the card line
and the final line.

It imports nothing of jax or of the reference package `repro`.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import zoo  # noqa: E402

# the lm-forward zoo module at full width, as a registry entrypoint
# ("chip_smoke:build_lm_forward_full")
build_lm_forward_full = functools.partial(zoo.build_lm_forward, reduced=False)

# H100 SXM, NVIDIA data sheet (dense): device-memory rate, the fp32 rate
# outside the tensor cores, and the TF32 and bf16 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# the fastest the card computes products at each input type's accuracy:
# fp32-accurate products as three TF32 tensor-core passes (3xTF32), bf16 at
# its tensor-core rate; every kernel's operations bound uses it
FLOP_PER_S = {torch.float32: TF32_FLOP_PER_S / 3,
              torch.bfloat16: BF16_FLOP_PER_S}

DEVICE = "cuda"
LLAMA, MAMBA = "llama3.2-3b", "mamba2-780m"
JAMBA, QWEN_MOE = "jamba-v0.1-52b", "qwen3-moe-30b-a3b"
WHISPER, PHI3V = "whisper-large-v3", "phi-3-vision-4.2b"
LAYERS = {LLAMA: 28, MAMBA: 48, WHISPER: 32, PHI3V: 32}
# full width in fp32 does not fit one 80 GB card, so these two are cut in
# depth, never in width: jamba to one super-block of 8 sub-layers (13.27 B
# params, every sub-layer kind of its plan), qwen3-moe to 16 of its 48
# layers (10.59 B params)
DEPTH_CUT = {JAMBA: 8, QWEN_MOE: 16}
BATCH, PROMPT, NEW = 4, 1024, 32
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (b, s_cache, hq, hkv, hd, length): the reference's DECODE_CASES
# (tests/test_kernels.py), then the llama3.2-3b serving shapes, where 8 CTAs
# split each (batch, kv head): lengths 1, 7 and 9 leave splits empty, 131
# and 1033 make the last share ragged, 1056 fills the cache; B=1 has 8
# clusters only
DECODE_CASES = [
    (1, 512, 4, 4, 64, 512), (2, 1024, 8, 2, 64, 700),
    (1, 2048, 4, 1, 128, 1), (2, 512, 4, 2, 64, 512), (1, 640, 4, 4, 32, 300),
    (4, 1056, 24, 8, 128, 1), (4, 1056, 24, 8, 128, 7),
    (4, 1056, 24, 8, 128, 9), (4, 1056, 24, 8, 128, 131),
    (4, 1056, 24, 8, 128, 1025), (4, 1056, 24, 8, 128, 1033),
    (4, 1056, 24, 8, 128, 1056), (1, 1056, 24, 8, 128, 5),
    (1, 1056, 24, 8, 128, 1040),
    # jamba's grouping (32 q heads on 8 kv heads: g=4, the G=4 instance
    # full) and qwen3-moe's (32 on 4: g=8, the G=8 instance), served
    (4, 1056, 32, 8, 128, 1040), (4, 1056, 32, 8, 128, 1),
    (4, 1056, 32, 4, 128, 1040), (4, 1056, 32, 4, 128, 1),
    # MHA (g=1, the G=1 instance): whisper's 20 heads of 64, and
    # phi-3-vision's 32 of 96 (rows on 32 / 16 lanes, 8 of them idle) at
    # lengths that leave splits empty, ragged and full, and B=1
    (4, 1056, 20, 20, 64, 1040), (4, 1056, 20, 20, 64, 1),
    (4, 1056, 32, 32, 96, 1), (4, 1056, 32, 32, 96, 7),
    (4, 1056, 32, 32, 96, 131), (4, 1056, 32, 32, 96, 1040),
    (4, 1056, 32, 32, 96, 1056), (1, 1056, 32, 32, 96, 5),
]
# (b, sq, sk, hq, hkv, hd): the reference's FLASH_CASES, then the
# llama3.2-3b forward shape; then, at its head counts, S=1 and S=7 (fewer
# rows than one 16-row mma tile), S=1000 and S=1040 (ragged against the
# 64-row and 64-key tiles), hd=16 at S=1024, and B=1
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64), (1, 384, 384, 4, 1, 32),
    (1, 200, 200, 4, 2, 64), (2, 128, 128, 4, 4, 128), (1, 512, 512, 2, 2, 16),
    (4, 1024, 1024, 24, 8, 128),
    (4, 1, 1, 24, 8, 128), (4, 7, 7, 24, 8, 128), (4, 1000, 1000, 24, 8, 128),
    (4, 1040, 1040, 24, 8, 128), (4, 1024, 1024, 24, 8, 16),
    (1, 1024, 1024, 24, 8, 128),
    # the jamba and qwen3-moe forwards' groupings
    (4, 1024, 1024, 32, 8, 128), (4, 1024, 1024, 32, 4, 128),
    # the whisper decoder's and phi-3-vision's forwards (MHA, hd 64 and
    # 96), and at hd 96: S = 1, 7, 1000, 1040 and B=1
    (4, 1024, 1024, 20, 20, 64), (4, 1024, 1024, 32, 32, 96),
    (4, 1, 1, 32, 32, 96), (4, 7, 7, 32, 32, 96),
    (4, 1000, 1000, 32, 32, 96), (4, 1040, 1040, 32, 32, 96),
    (1, 1024, 1024, 32, 32, 96),
]
# inputs x3 against fp64: (hq, hkv, hd) of llama's and phi-3-vision's
# forwards
PEAKY_CASES = [(24, 8, 128), (32, 32, 96)]
# (b, L, h, p, g, n, chunk): the full-width mamba2-780m prefill shape, and
# jamba's (128 heads, d_state 16)
SSD_FULL = (4, 1024, 48, 64, 1, 128, 128)
SSD_JAMBA = (4, 1024, 128, 64, 1, 16, 128)
# the reference's SSD_CASES, the reduced mamba2-780m shape, then the
# full-width prefill shape, a ragged L=1000 and L=4096 (32 chunks)
SSD_CASES = [
    (1, 256, 2, 64, 1, 64, 64), (2, 128, 4, 32, 2, 16, 32),
    (1, 512, 2, 64, 1, 128, 128), (1, 128, 2, 64, 1, 16, 64),
    (2, 20, 8, 16, 1, 16, 16),
    SSD_FULL, (4, 1000, 48, 64, 1, 128, 128), (4, 4096, 48, 64, 1, 128, 128),
]
# the kernel instantiations the main paths run, as ptxas names them
# (mangled): decode at hd=128, g<=4 (llama, jamba) and g<=8 (qwen3-moe, fp32
# and bf16), and g=1 at hd=64 (whisper) and hd=96 (phi-3-vision); SSD at
# P=64, N=128 (mamba2-780m) and N=16 (jamba), with their C.B^T kernels;
# flash at hd=128, 64 and 96
FLASH_MAIN = "flash_kernelIfLi128E"
DECODE_G1 = ("decode_kernelIfLi64ELi1E", "decode_kernelIfLi96ELi1E")
MAIN_PATH_INSTANCES = (
    "decode_kernelIfLi128ELi4E", "decode_kernelIfLi128ELi8E",
    "decode_kernelI13__nv_bfloat16Li128ELi8E", *DECODE_G1,
    "ssd_chunk_state_kernelIfLi64ELi128E",
    "ssd_chunk_scan_kernelIfLi64ELi128E", "ssd_cb_kernelIfLi128E",
    "ssd_chunk_state_kernelIfLi64ELi16E",
    "ssd_chunk_scan_kernelIfLi64ELi16E", "ssd_cb_kernelIfLi16E",
    "ssd_state_pass_kernel", FLASH_MAIN, "flash_kernelIfLi64E",
    "flash_kernelIfLi96E")
# the flash instances whose SASS must hold HMMA (tensor-core) instructions
FLASH_HMMA = (FLASH_MAIN, "flash_kernelI13__nv_bfloat16Li128E",
              "flash_kernelIfLi96E", "flash_kernelI13__nv_bfloat16Li96E")
# y and final state, as the reference's test_ssd_kernel_matches_ref
SSD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def err_within(got, want, tol) -> tuple[float, bool]:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= tol + tol * want.abs())) and \
        bool(torch.isfinite(got).all())
    return float(diff.max()), ok


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.results: dict = {}

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"[{'ok' if ok else 'FAIL'}] {name} {detail}".rstrip(),
              flush=True)
        if not ok:
            self.failures.append(name)

    def phase(self, name: str, fn) -> None:
        """Run one phase; print its wall time, the most device memory it
        held, and what is still allocated once it has returned (its
        tensors freed)."""
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc()
            self.check(f"{name}: raised", False)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        self.results.setdefault("phases", {})[name] = {
            "wall_s": wall, "max_memory_allocated_gb": peak}
        print(f"   {name}: {wall:.1f} s, max_memory_allocated "
              f"{peak:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"still allocated", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_setup(smoke: Smoke) -> None:
    from repro_torch.kernels import _build
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = _build.build()
    smoke.results["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(libs)} in {smoke.results['build_s']:.1f} s")
    main_path = []
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text() \
            if lib.with_suffix(".log").exists() else ""
        kernels = _ptxas_kernels(log)
        regs = [k["registers"] for k in kernels]
        print(f"ptxas {name}: {len(kernels)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"spill stores {max((k['spill'] for k in kernels), default=0)}"
              f" bytes")
        for k in kernels:
            if k["spill"]:
                print(f"   spills {k['spill']} bytes: {k['name']}")
            if any(m in k["name"] for m in MAIN_PATH_INSTANCES):
                main_path.append(k)
                print(f"   main path: {k['registers']} registers, "
                      f"{k['spill']} bytes spilled: {k['name']}")
    smoke.results["ptxas_main_path"] = main_path
    missing = [m for m in MAIN_PATH_INSTANCES
               if not any(m in k["name"] for k in main_path)]
    smoke.check("ptxas: main-path instantiations do not spill",
                not missing and not any(k["spill"] for k in main_path),
                f"{len(main_path)} kernels, not found: {missing or 'none'}")
    # the MHA decode instances (whisper, phi-3-vision): registers, and the
    # CTAs of 256 threads an SM that registers and shared memory allow
    for k in main_path:
        inst = next((m for m in DECODE_G1 if m in k["name"]), None)
        if inst:
            k["ctas_per_sm"] = _ctas_per_sm(k["registers"], k["smem"], 256)
            smoke.results.setdefault("decode_g1", {})[inst] = k
            print(f"   {inst}: {k['registers']} registers, {k['smem']} "
                  f"bytes shared, {k['ctas_per_sm']} CTAs an SM")
    # the flash kernel's products run on the tensor cores: HMMA in its SASS
    for inst in FLASH_HMMA:
        hmma = _hmma_count(libs["flash_attention"], inst)
        smoke.results.setdefault("sass_hmma", {})[inst] = hmma
        if hmma is None:
            print(f"sass {inst}: not read (no cuobjdump in the toolkit)")
        else:
            smoke.check(f"sass {inst}: HMMA instructions", hmma > 0,
                        str(hmma))


def _hmma_count(lib: Path, kernel: str) -> int | None:
    """How many HMMA (tensor-core) instructions the SASS of the kernel whose
    mangled name holds `kernel` has; None where the toolkit has no
    cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(r"\bHMMA\b", line):
            count += 1
    return count


def _ptxas_kernels(log: str) -> list[dict]:
    """Each entry function of a `-Xptxas -v` log, with its registers, spill
    stores and static shared memory."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append({"name": m.group(1), "registers": 0, "spill": 0,
                            "smem": 0})
        elif kernels and (m := re.search(r"(\d+) bytes spill stores", line)):
            kernels[-1]["spill"] = int(m.group(1))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                kernels[-1]["smem"] = int(m.group(1))
    return kernels


def _ctas_per_sm(registers: int, smem: int, threads: int) -> int:
    """CTAs of `threads` threads that fit on one H100 SM: 65536 registers
    (allocated per warp in units of 256), 228 KB of shared memory (1 KB of
    it reserved per CTA), 2048 threads and 32 CTAs."""
    warps = threads // 32
    regs = warps * -(-registers * 32 // 256) * 256
    return min(65536 // max(regs, 1), 233472 // (smem + 1024),
               2048 // threads, 32)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _attention_fp64(q, k, v):
    """Causal GQA attention computed in fp64: [B,S,Hq,hd] -> [B,S,Hq,hd]."""
    s, hq, hd = q.shape[1:]
    g = hq // k.shape[2]
    kr, vr = (t.double().repeat_interleave(g, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def _ssd_inputs(gen, b, l, h, p, g, n, dtype):
    """x, dt, a, B, C by the reference test's recipe: dt = softplus(z - 1),
    a = -exp(0.3 z)."""
    x = _randn(gen, (b, l, h, p), dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (b, l, h), torch.float32)
                                      - 1.0)
    a = -torch.exp(_randn(gen, (h,), torch.float32) * 0.3)
    return (x, dt, a, _randn(gen, (b, l, g, n), dtype),
            _randn(gen, (b, l, g, n), dtype))


def _ssd_model_inputs(gen, b, l, h, p, g, n, dtype):
    """x, dt, a, B, C over the ranges of the model's own init (api.py:
    `a_log`, `dt_bias`): a from -1 to -16 and dt from 1e-3 to 1e-1 over the
    heads, so the slowest heads carry their state across whole chunks."""
    x = _randn(gen, (b, l, h, p), dtype)
    dt_bias = torch.log(torch.expm1(torch.logspace(-3, -1, h, device=DEVICE)))
    dt = torch.nn.functional.softplus(
        0.1 * _randn(gen, (b, l, h), torch.float32) + dt_bias)
    a = -torch.linspace(1.0, 16.0, h, device=DEVICE)
    return (x, dt, a, _randn(gen, (b, l, g, n), dtype),
            _randn(gen, (b, l, g, n), dtype))


def _check_ssd(smoke, name, got, want, dtype):
    (y, s), (y_want, s_want) = got, want
    tol_y, tol_s = SSD_TOL[dtype]
    err_y, ok_y = err_within(y, y_want, tol_y)
    err_s, ok_s = err_within(s, s_want, tol_s)
    smoke.check(name, ok_y and ok_s,
                f"max_abs_err y={err_y:.3g} state={err_s:.3g}")


def phase_kernels(smoke: Smoke) -> None:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for b, s, hq, hkv, hd, length in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, hq, hd), dtype)
            k = _randn(gen, (b, s, hkv, hd), dtype)
            v = _randn(gen, (b, s, hkv, hd), dtype)
            got = da.decode_attention(q, k, v, length, scale=hd ** -0.5)
            want = da.decode_attention_plain(q, k, v, length,
                                             scale=hd ** -0.5)
            torch.cuda.synchronize()
            err, ok = err_within(got, want, TOL[dtype])
            smoke.check(f"decode_attention b={b} s={s} hq={hq} hkv={hkv} "
                        f"hd={hd} length={length} {dtype}", ok,
                        f"max_abs_err={err:.3g}")
    for b, sq, sk, hq, hkv, hd in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, sq, hq, hd), dtype)
            k = _randn(gen, (b, sk, hkv, hd), dtype)
            v = _randn(gen, (b, sk, hkv, hd), dtype)
            got = fa.flash_attention(q, k, v, causal=True)
            want = fa.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err, ok = err_within(got, want, TOL[dtype])
            smoke.check(f"flash_attention b={b} sq={sq} sk={sk} hq={hq} "
                        f"hkv={hkv} hd={hd} {dtype}", ok,
                        f"max_abs_err={err:.3g}")
    # a peaky softmax: the full-width shapes with inputs x3 (scores x9),
    # where fp32 itself drifts from the exact result.  The kernel keeps
    # fp32's accuracy if its error against an fp64 computation is at most
    # twice the plain fp32 version's
    for hq, hkv, hd in PEAKY_CASES:
        q, k, v = (3 * _randn(gen, (4, 1024, h, hd), torch.float32)
                   for h in (hq, hkv, hkv))
        exact = _attention_fp64(q, k, v)
        err_kernel = float((fa.flash_attention(q, k, v, causal=True)
                            .double() - exact).abs().max())
        err_plain = float((fa.flash_attention_plain(q, k, v, causal=True)
                           .double() - exact).abs().max())
        smoke.check(f"flash_attention inputs x3 hq={hq} hkv={hkv} hd={hd} "
                    f"float32: error vs fp64 within 2x the plain fp32 "
                    f"version's", err_kernel <= 2 * err_plain,
                    f"kernel {err_kernel:.3g}, plain fp32 {err_plain:.3g}")
        del q, k, v, exact
    for b, l, h, p, g, n, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(gen, b, l, h, p, g, n, dtype)
            got = ssd.ssd(*args, chunk=chunk, impl="pallas")
            want = ssd.ssd(*args, chunk=chunk, impl="xla")
            torch.cuda.synchronize()
            _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} n={n} "
                       f"chunk={chunk} {dtype}", got, want, dtype)
    # the full-width shapes (mamba2-780m's, jamba's) at the model's decay
    # and step ranges, where the state is carried across whole chunks
    for b, l, h, p, g, n, chunk in (SSD_FULL, SSD_JAMBA):
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_model_inputs(gen, b, l, h, p, g, n, dtype)
            got = ssd.ssd(*args, chunk=chunk, impl="pallas")
            want = ssd.ssd(*args, chunk=chunk, impl="xla")
            torch.cuda.synchronize()
            _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} "
                       f"n={n} chunk={chunk} model ranges {dtype}", got,
                       want, dtype)
    # full-width continuation: 512 steps, then 512 more from the carried
    # state, against one 1024-step scan (tolerance as the reference's)
    b, l, h, p, g, n, chunk = SSD_FULL
    x, dt, a, bb, cc = _ssd_inputs(gen, b, l, h, p, g, n, torch.float32)
    y_full, s_full = ssd.ssd(x, dt, a, bb, cc, chunk=chunk, impl="xla")
    half = l // 2
    _, s1 = ssd.ssd(x[:, :half], dt[:, :half], a, bb[:, :half],
                    cc[:, :half], chunk=chunk, impl="pallas")
    y2, s2 = ssd.ssd(x[:, half:], dt[:, half:], a, bb[:, half:],
                     cc[:, half:], chunk=chunk, impl="pallas",
                     initial_state=s1)
    torch.cuda.synchronize()
    err_y, ok_y = err_within(y2, y_full[:, half:], 1e-4)
    err_s, ok_s = err_within(s2, s_full, 1e-4)
    smoke.check("ssd_scan continuation 512+512 vs 1024 (1e-4)", ok_y and ok_s,
                f"max_abs_err y={err_y:.3g} state={err_s:.3g}")


def _counters() -> dict:
    """The kernel wrappers, by kernel name; each counts its launches."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"decode_attention": da.decode_attention,
            "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd}


def _reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _check_launches(smoke, what, got, want) -> None:
    for name in sorted(want):
        smoke.check(f"{what}: {name} launches", got[name] == want[name],
                    f"{got[name]} (want {want[name]})")


def _full_cfg(arch, impl):
    """Full-width config in fp32 (weights, activations, cache), as the
    serving path (`launch/serve.py`) runs it, with both kernel knobs set
    to `impl` and the MoE route following them as serving sets it
    ("pallas": the gather route "ep"; "xla": the one-hot oracle "dense");
    DEPTH_CUT's models cut in depth."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              kv_dtype=torch.float32, attn_impl=impl,
                              ssd_impl=impl)
    if arch in DEPTH_CUT:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUT[arch])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep" if impl == "pallas" else "dense"))
    return cfg


@contextlib.contextmanager
def _depth_cut():
    """`configs.get` (which `serve` reads its config from) hands out
    DEPTH_CUT's full configs with their depth cut and their widths
    unchanged."""
    import dataclasses
    from repro_torch import configs
    real = configs.get

    def get(arch_id, reduced=False):
        cfg = real(arch_id, reduced)
        if reduced or arch_id not in DEPTH_CUT:
            return cfg
        return dataclasses.replace(cfg, n_layers=DEPTH_CUT[arch_id])
    configs.get = get
    try:
        yield
    finally:
        configs.get = real


def _params(cfg, seed=0):
    from repro_torch.models import api
    return api.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(seed))


def phase_serve(smoke: Smoke, arch: str) -> None:
    from repro_torch.launch.serve import ServeRun, serve
    layers = LAYERS[arch]
    run = ServeRun(arch=arch, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    _reset_launches()
    out = serve(run)
    launches = _read_launches()
    # llama, whisper, phi-3-vision: the decode kernel at every (decoder)
    # layer of every decode step (prefill, and whisper's encoder and cross
    # attention, are plain, as the reference's); mamba: the SSD scan at
    # every layer of the prefill (its decode step is plain torch)
    want = ({"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers}
            if arch == MAMBA else
            {"decode_attention": layers * (NEW - 1), "flash_attention": 0,
             "ssd_scan": 0})
    smoke.results.setdefault("launches", {})[f"serve {arch}"] = launches
    _check_launches(smoke, f"serve {arch}", launches, want)
    tokens, logits = torch.from_numpy(out["tokens"]), out["logits"]
    cfg = _full_cfg(arch, "xla")
    smoke.check(f"serve {arch}: tokens shape and range",
                tuple(tokens.shape) == (BATCH, NEW)
                and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    smoke.check(f"serve {arch}: logits finite",
                bool(torch.isfinite(logits).all()))

    # the plain path, same weights and prompt, fed the served tokens
    params = _params(cfg, run.seed)
    plain = _teacher_forced(cfg, params, out["prompt"], tokens,
                            out["extra"])
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3))
    smoke.results.setdefault("serve", {})[arch] = {
        "batch": BATCH, "prompt_len": PROMPT, "new_tokens": NEW,
        "prefill_s": out["prefill_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "launches": launches, "max_abs_logit_err_vs_plain": err}
    smoke.check(f"serve {arch}: logits vs plain path (atol=rtol=1e-3)", ok,
                f"max_abs_err={err:.3g}")


def _teacher_forced(cfg, params, prompt, tokens, extra=None):
    """The logits of prefill and of each decode step on `cfg`'s path, fed
    the served `tokens` [B, NEW]: the plain rerun of a served run.  `extra`:
    the prompt's other inputs (whisper's frames, phi-3-vision's patches)."""
    from repro_torch.models import stack
    toks = tokens.to(prompt.device, torch.int32)
    with torch.inference_mode():
        cache, plain = stack.build_prefill_fn(cfg, PROMPT + NEW)(
            params, {**(extra or {}), "tokens": prompt})
        plain_logits = [plain]
        decode = stack.build_decode_fn(cfg)
        for i in range(NEW - 1):
            cache, _, lg = decode(params, cache, toks[:, i:i + 1], PROMPT + i)
            plain_logits.append(lg)
    return torch.stack(plain_logits, dim=1)


def phase_forward(smoke: Smoke, arch: str) -> None:
    from repro_torch.models import io, stack
    layers = LAYERS[arch]
    cfg_k, cfg_p = _full_cfg(arch, "pallas"), _full_cfg(arch, "xla")
    params = _params(cfg_p)
    # tokens (and whisper's frames or phi-3-vision's patches)
    batch = io.make_batch(cfg_p, io.smoke_cell("train", BATCH, PROMPT),
                          torch.Generator(device=DEVICE).manual_seed(1))
    with torch.inference_mode():
        _reset_launches()
        h, _ = stack.forward(params, cfg_k, batch)
        launches = _read_launches()
        h_plain, _ = stack.forward(params, cfg_p, batch)
    # flash at every (decoder) layer; whisper's encoder is non-causal and
    # stays plain, as the reference's
    want = ({"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers}
            if arch == MAMBA else
            {"decode_attention": 0, "flash_attention": layers,
             "ssd_scan": 0})
    smoke.results.setdefault("launches", {})[f"forward {arch}"] = launches
    _check_launches(smoke, f"forward {arch}", launches, want)
    err = float((h - h_plain).abs().max())
    smoke.results.setdefault("forward", {})[arch] = {
        "batch": BATCH, "seq": PROMPT, "launches": launches,
        "max_abs_hidden_err_vs_plain": err}
    smoke.check(f"forward {arch}: hidden state vs plain path "
                f"(atol=rtol=1e-3)",
                bool(torch.isfinite(h).all())
                and bool(torch.allclose(h, h_plain, atol=1e-3, rtol=1e-3)),
                f"max_abs_err={err:.3g}")


# A top-k choice whose k-th and (k+1)-th probabilities lie closer than this
# is a tie at fp32 noise: kernel and plain attention differ by ~1e-5 in the
# hidden state, ~1e-7 in a router probability, and a routing flip there
# moves that token's hidden state by ~1e-2, far past the 1e-3 checks.
TIE_GAP = 1e-6


class _Routes:
    """Records each MoE router call's top-k experts, the top k+1
    probabilities (for the gap at the top-k boundary), and which tokens'
    choices were pinned, while a run is inside `record(name)`.  It wraps
    `moe.router_probs`, which both MoE routes call.

    A plain rerun records with `follow` set to the run it is held to, and
    is teacher-forced on that run's routes where they tie, as it is on the
    served tokens: where its own top-k set differs from the followed run's
    at call j and its own gap is below TIE_GAP, it takes the followed
    run's experts (and their probabilities, renormalised).  A difference
    at a larger gap is left alone, and `differ` counts it."""

    def __init__(self):
        self.calls: dict[str, list] = {}

    @contextlib.contextmanager
    def record(self, name, follow=None):
        from repro_torch.models import moe
        real, log = moe.router_probs, self.calls.setdefault(name, [])

        def router_probs(params, x, spec):
            top_p, top_i, aux = real(params, x, spec)
            k = spec.top_k
            probs = torch.softmax(x.float() @ params["w_router"].float(), -1)
            top = torch.sort(probs, dim=-1, descending=True,
                             stable=True).values[:, :k + 1]
            pinned = torch.zeros(top_i.shape[0], dtype=torch.bool,
                                 device=top_i.device)
            own = top_i.clone()
            if follow is not None:
                ref = self.calls[follow][len(log)][0]
                same = (top_i[:, :, None] == ref[:, None, :]).any(-1).all(-1)
                pinned = ~same & (top[:, k - 1] - top[:, k] < TIE_GAP)
                top_i = torch.where(pinned[:, None], ref, top_i)
                p = probs.gather(1, top_i)
                top_p = torch.where(pinned[:, None],
                                    p / p.sum(-1, keepdim=True), top_p)
            log.append((own, top, pinned))
            return top_p, top_i, aux
        moe.router_probs = router_probs
        try:
            yield
        finally:
            moe.router_probs = real

    def differ(self, a: str, b: str, n_moe: int) -> dict:
        """(token, expert) routes run `a` chose and run `b`'s own choice did
        not, per MoE sub-layer (call j is sub-layer j % n_moe); of them,
        those `b` pinned to `a`'s at a tie and those it did not; and the
        first difference with both runs' gaps between their k-th and
        (k+1)-th probability."""
        ca, cb = self.calls[a], self.calls[b]
        out = {"calls": [len(ca), len(cb)], "per_sublayer": [0] * n_moe,
               "pinned_per_sublayer": [0] * n_moe, "not_ties": 0,
               "routes_per_sublayer": [0] * n_moe, "first": None}
        for j, ((ia, pa, _), (ib, pb, pinned)) in enumerate(zip(ca, cb)):
            differs = ~(ia[:, :, None] == ib[:, None, :]).any(-1)  # [T, K]
            n = int(differs.sum())
            n_pinned = int(differs[pinned].sum())
            out["per_sublayer"][j % n_moe] += n
            out["pinned_per_sublayer"][j % n_moe] += n_pinned
            out["not_ties"] += n - n_pinned
            out["routes_per_sublayer"][j % n_moe] += ia.numel()
            if n and out["first"] is None:
                t = int(differs.any(-1).nonzero()[0])
                k = ia.shape[1]
                out["first"] = {
                    "call": j, "sublayer": j % n_moe, "step": j // n_moe,
                    "token": t, "experts_" + a: ia[t].tolist(),
                    "experts_" + b: ib[t].tolist(),
                    "gap_" + a: float(pa[t, k - 1] - pa[t, k]),
                    "gap_" + b: float(pb[t, k - 1] - pb[t, k])}
        return out


def _check_routes(smoke, what, routes, a, b, n_moe, n_calls) -> dict:
    """Print the (token, expert) routes that differ between run `a` and
    the plain run `b` per MoE sub-layer, and the first of them with its
    gaps; check that both ran `n_calls` router calls and that every
    difference was a tie `b` was pinned at."""
    diff = routes.differ(a, b, n_moe)
    print(f"   {what}: (token, expert) routes of the kernel path the plain "
          f"path chose otherwise, per MoE sub-layer: {diff['per_sublayer']} "
          f"of {diff['routes_per_sublayer']}; pinned at ties (gap < "
          f"{TIE_GAP:g}): {diff['pinned_per_sublayer']}; first: "
          f"{diff['first']}")
    smoke.check(f"{what}: the plain rerun routed the same calls",
                diff["calls"][0] == diff["calls"][1] == n_calls,
                f"{diff['calls']}")
    smoke.check(f"{what}: routes differ only at ties (gap < {TIE_GAP:g})",
                diff["not_ties"] == 0,
                f"{diff['not_ties']} routes differ at a larger gap")
    return diff


def _sublayer_counts(cfg) -> dict:
    n_groups, plan = cfg.layer_plan()
    return {kind: n_groups * sum(1 for item in plan if kind in item)
            for kind in ("attn", "mamba", "moe")}


def phase_moe_model(smoke: Smoke, arch: str) -> None:
    """Phases 9 and 10: a DEPTH_CUT model at full width in fp32.  Serve it
    (B=4, a 1024-token prompt, 32 new tokens, greedy, the kernel path with
    the gather MoE route) and hold every step's logits to a teacher-forced
    plain rerun (plain attention and SSD, the one-hot MoE oracle) on the
    same weights; run its forward on both paths; hold one MoE layer's
    gather route to the oracle at the prefill's and a decode step's token
    counts; time prefill, decode and the MoE layer, and profile a
    prefill.  The params are freed before it returns."""
    from repro_torch.launch.serve import ServeRun, serve
    from repro_torch.models import api, stack
    res = smoke.results.setdefault("moe_models", {}).setdefault(arch, {})
    cfg_k, cfg_p = _full_cfg(arch, "pallas"), _full_cfg(arch, "xla")
    n = _sublayer_counts(cfg_k)
    n_moe = n["moe"]
    res.update(n_layers=cfg_k.n_layers, sublayers=n,
               params=api.param_count(cfg_k))
    print(f"   {arch} cut to {cfg_k.n_layers} layers: {n}, "
          f"{res['params'] / 1e9:.3f} B params "
          f"({4 * res['params'] / 1e9:.2f} GB in fp32)")
    routes = _Routes()

    # serve, as phases 3 and 5 do
    run = ServeRun(arch=arch, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    with _depth_cut(), routes.record("served"):
        _reset_launches()
        out = serve(run)
        launches = _read_launches()
    smoke.results.setdefault("launches", {})[f"serve {arch}"] = launches
    _check_launches(smoke, f"serve {arch}", launches, {
        "decode_attention": n["attn"] * (NEW - 1), "flash_attention": 0,
        "ssd_scan": n["mamba"]})
    tokens, logits = torch.from_numpy(out["tokens"]), out["logits"]
    smoke.check(f"serve {arch}: tokens shape and range",
                tuple(tokens.shape) == (BATCH, NEW)
                and bool(((tokens >= 0) & (tokens < cfg_k.vocab)).all()))
    smoke.check(f"serve {arch}: logits finite",
                bool(torch.isfinite(logits).all()))
    params = _params(cfg_p, run.seed)
    with routes.record("plain", follow="served"):
        plain = _teacher_forced(cfg_p, params, out["prompt"], tokens)
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3))
    diff = _check_routes(smoke, f"serve {arch}", routes, "served", "plain",
                         n_moe, n_moe * NEW)
    smoke.check(f"serve {arch}: logits vs plain path (atol=rtol=1e-3)", ok,
                f"max_abs_err={err:.3g}" + ("" if ok else
                                            f"; first flip {diff['first']}"))
    res["serve"] = {"prefill_s": out["prefill_s"],
                    "decode_tok_per_s": out["decode_tok_per_s"],
                    "launches": launches, "max_abs_logit_err_vs_plain": err,
                    "route_diff": diff}
    del out, logits, plain

    # the cache-free forward on both paths
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    fwd = {"tokens": torch.randint(0, cfg_p.vocab, (BATCH, PROMPT),
                                   generator=gen, device=DEVICE,
                                   dtype=torch.int32)}
    with torch.inference_mode():
        with routes.record("forward"):
            _reset_launches()
            h, aux = stack.forward(params, cfg_k, fwd)
            launches = _read_launches()
        with routes.record("forward plain", follow="forward"):
            h_plain, aux_plain = stack.forward(params, cfg_p, fwd)
    smoke.results["launches"][f"forward {arch}"] = launches
    _check_launches(smoke, f"forward {arch}", launches, {
        "decode_attention": 0, "flash_attention": n["attn"],
        "ssd_scan": n["mamba"]})
    err = float((h - h_plain).abs().max())
    fdiff = _check_routes(smoke, f"forward {arch}", routes, "forward",
                          "forward plain", n_moe, n_moe)
    smoke.check(f"forward {arch}: hidden state vs plain path "
                f"(atol=rtol=1e-3)",
                bool(torch.isfinite(h).all())
                and bool(torch.allclose(h, h_plain, atol=1e-3, rtol=1e-3)),
                f"max_abs_err={err:.3g}, aux {float(aux):.6g} vs "
                f"{float(aux_plain):.6g}")
    res["forward"] = {"launches": launches,
                      "max_abs_hidden_err_vs_plain": err,
                      "aux": float(aux), "aux_plain": float(aux_plain),
                      "route_diff": fdiff}
    del h, h_plain, routes

    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    res["moe_layer"] = _moe_layer_alone(smoke, arch, cfg_k, params, flush)
    res["times"] = _serve_times(cfg_k, params, flush, (
        "profile_prefill_moe_stages", _moe_stage_profile))
    smoke.results.setdefault("times", {})[arch] = res["times"]
    del params, flush
    gc.collect()
    torch.cuda.empty_cache()


def _moe_layer_alone(smoke, arch, cfg, params, flush) -> dict:
    """The first MoE sub-layer's weights on a normalised input of T = 4096
    tokens (the prefill) and T = 4 (a decode step): the gather route and
    the one-hot oracle choose the same experts, drop the same (token, k)
    pairs, and agree within 2e-5 (aux within 1e-6); with a zero router
    every token takes experts 0 .. k-1.  Times the gather route and the
    oracle at T = 4096."""
    import dataclasses
    from repro_torch.models import layers, moe, stack
    i = next(i for i, (_, ffn) in enumerate(cfg.layer_plan()[1])
             if ffn == "moe")
    sub = params["blocks"][f"sub{i}"]
    p = {k: v[0] for k, v in sub["moe"].items()}
    spec = stack.moe_spec(cfg)
    e, k = spec.n_experts, spec.top_k
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    with torch.inference_mode():
        for t in (BATCH * PROMPT, BATCH):
            x = layers.rms_norm(
                torch.randn((1, t, cfg.d_model), generator=gen,
                            device=DEVICE), sub["ln2_w"][0])
            xt = x[0]
            top_p, top_i, _ = moe.router_probs(p, xt, spec)
            top_p2, top_i2, _ = moe.router_probs(p, xt, spec)
            cap = moe._capacity(t, spec)
            disp, _ = moe._dense_dispatch(top_p, top_i, cap, spec, x.dtype)
            kept_dense = disp.sum(-1) > 0                      # [T, E]
            _, src, w = moe._sorted_dispatch(xt, top_p2, top_i2, cap, spec)
            kept_ep = torch.zeros_like(kept_dense)
            ids = torch.arange(e, device=DEVICE)[:, None].expand_as(src)
            kept_ep[src[w > 0], ids[w > 0]] = True
            dropped = t * k - int(kept_ep.sum())
            del disp
            y_ep, aux_ep = moe.moe_ep(p, x, spec)
            y_d, aux_d = moe.moe_dense(p, x, spec)
            err, ok = err_within(y_ep, y_d, 2e-5)
            aux_err = abs(float(aux_ep) - float(aux_d))
            smoke.check(f"{arch} MoE layer T={t}: gather route vs one-hot "
                        f"oracle (same experts, same drops, 2e-5, aux 1e-6)",
                        torch.equal(top_i, top_i2)
                        and torch.equal(kept_dense, kept_ep) and ok
                        and aux_err <= 1e-6,
                        f"capacity {cap}, {dropped} of {t * k} (token, k) "
                        f"pairs dropped, max_abs_err={err:.3g}, aux "
                        f"err={aux_err:.3g}")
            out[f"T={t}"] = {"capacity": cap, "pairs": t * k,
                             "dropped": dropped, "max_abs_err": err,
                             "aux_err": aux_err}
            if t == BATCH * PROMPT:
                out["ms_gather"] = time_ms(lambda: moe.moe_ep(p, x, spec),
                                           flush, reps=10, warmup=2)
                out["ms_dense_oracle"] = time_ms(
                    lambda: moe.moe_dense(p, x, spec), flush, reps=5,
                    warmup=1)
                out["profile_gather"] = _moe_stage_profile(
                    lambda: moe.moe_ep(p, x, spec))
            del y_ep, y_d
        zero = dict(p, w_router=torch.zeros_like(p["w_router"]))
        _, ties, _ = moe.router_probs(zero, xt, spec)
        smoke.check(f"{arch} MoE router: equal probabilities take experts "
                    f"0 .. k-1 on the card",
                    bool((ties == torch.arange(k, device=DEVICE)).all()))
    print(f"   {arch} MoE layer: {out}")
    return out


@contextlib.contextmanager
def _moe_stage_ranges():
    """torch.profiler ranges around the MoE layer's stages: router
    (`router_probs`), dispatch (`_sorted_dispatch`: the sort and the
    gather), experts (`_expert_ffn`: three bmm) and the whole layer
    (`moe_ep`; what the three leave is the weighting and `index_add_`)."""
    from repro_torch.models import moe
    names = {"router_probs": "moe.router",
             "_sorted_dispatch": "moe.dispatch",
             "_expert_ffn": "moe.experts", "moe_ep": "moe.layer"}
    real = {fn: getattr(moe, fn) for fn in names}

    def ranged(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(names[fn]):
                return real[fn](*args, **kwargs)
        return run
    for fn in names:
        setattr(moe, fn, ranged(fn))
    try:
        yield
    finally:
        for fn, f in real.items():
            setattr(moe, fn, f)


def _moe_stage_profile(fn) -> dict:
    """fn() under torch.profiler with `_moe_stage_ranges`: the device time
    of each stage's kernels (summed over the MoE layers fn runs), of all
    kernels, and each stage's share of the latter."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with _moe_stage_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stage = {}
    for e in prof.events():
        if e.name.startswith("moe.") and e.device_type.name == "CPU":
            stage[e.name] = stage.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith("moe.")) / 1e3
    if not busy:
        return {"device_busy_ms": "not measured"}
    layer = stage.pop("moe.layer", 0.0)
    if layer:
        stage["moe.combine (weights, index_add_)"] = layer - sum(
            stage.get(k, 0.0) for k in ("moe.router", "moe.dispatch",
                                        "moe.experts"))
    return {"device_busy_ms": busy, "moe_layers_ms": layer,
            "stage_ms": stage,
            "stage_share": {k: v / busy for k, v in stage.items()}}


def _serve_times(cfg, params, flush, stages) -> dict:
    """Prefill ms (CUDA events, median of 5), the median decode step ms
    over a served run's 31 steps, and torch.profiler breakdowns of three
    decode steps and of one prefill; `stages` = (key, profile function)
    adds a breakdown of one prefill with the model's stages named."""
    from repro_torch.models import io, stack
    with torch.inference_mode():
        batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                              torch.Generator(device=DEVICE).manual_seed(1))
        prefill = stack.build_prefill_fn(cfg, PROMPT + NEW)
        times = {"prefill_ms": time_ms(lambda: prefill(params, batch), flush,
                                       reps=5, warmup=1)}
        cache, logits = prefill(params, batch)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        decode = stack.build_decode_fn(cfg)
        steps = []
        for i in range(NEW - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cache, nxt, _ = decode(params, cache, tok, PROMPT + i)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
            tok = nxt[:, None]
        step_ms = statistics.median(steps[1:])
        times.update({"decode_step_ms": step_ms,
                      "decode_tok_per_s": BATCH * 1e3 / step_ms,
                      "decode_steps_timed": len(steps) - 1})

        def three_steps():
            c, t = cache, tok
            for i in range(3):
                c, n, _ = decode(params, c, t, PROMPT + NEW - 4 + i)
                t = n[:, None]
        times["profile_decode_3_steps"] = _profile(three_steps)
        del cache
        times["profile_prefill"] = _profile(lambda: prefill(params, batch))
        if stages is not None:
            key, stage_profile = stages
            times[key] = stage_profile(lambda: prefill(params, batch))
    print(f"   times: prefill {times['prefill_ms']:.1f} ms, decode step "
          f"{step_ms:.2f} ms" + (f", stages of one prefill {times[key]}"
                                 if stages is not None else ""))
    return times


def phase_encdec_vlm(smoke: Smoke, arch: str) -> None:
    """Phases 11 and 12: whisper-large-v3 and phi-3-vision-4.2b at full
    width and depth in fp32, their stub frames / patches from
    `io.make_batch`: served and run cache-free as phases 3 and 4 do, then
    prefill and decode timed and a prefill profiled (whisper's with its
    encoder and cross attention named).  The params are freed before it
    returns."""
    from repro_torch.models import api
    cfg = _full_cfg(arch, "pallas")
    n = api.param_count(cfg)
    print(f"   {arch}: {cfg.n_layers} decoder layers, {cfg.n_enc_layers} "
          f"encoder layers, {n / 1e9:.3f} B params ({4 * n / 1e9:.2f} GB "
          f"in fp32)")
    phase_serve(smoke, arch)
    phase_forward(smoke, arch)
    params = _params(cfg)
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    smoke.results.setdefault("times", {})[arch] = _serve_times(
        cfg, params, flush,
        ("profile_prefill_stages", _whisper_stage_profile)
        if arch == WHISPER else None)
    del params, flush
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _whisper_stage_ranges():
    """torch.profiler ranges around whisper's stages: the encoder
    (`stack._encode`), the cross attention's k/v from the encoder states
    (`layers.cross_kv_from_encoder`) and the cross attention itself
    (`layers.attention` called with `cross_kv`)."""
    from repro_torch.models import layers, stack
    real = (stack._encode, layers.cross_kv_from_encoder, layers.attention)

    def ranged(name, fn, only_cross=False):
        def run(*args, **kwargs):
            if only_cross and kwargs.get("cross_kv") is None:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    stack._encode = ranged("whisper.encoder", real[0])
    layers.cross_kv_from_encoder = ranged("whisper.cross_kv", real[1])
    layers.attention = ranged("whisper.cross_attention", real[2], True)
    try:
        yield
    finally:
        stack._encode, layers.cross_kv_from_encoder, layers.attention = real


def _whisper_stage_profile(fn) -> dict:
    """fn() under torch.profiler with `_whisper_stage_ranges`: the device
    time of the encoder, the cross k/v, the cross attention and the rest
    (the decoder's self attention, MLPs and the logits), and their shares
    of all kernels' time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with _whisper_stage_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stage = {}
    for e in prof.events():
        if e.name.startswith("whisper.") and e.device_type.name == "CPU":
            stage[e.name] = stage.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith("whisper.")) / 1e3
    if not busy:
        return {"device_busy_ms": "not measured"}
    stage["decoder (self attention, MLPs, logits)"] = busy - sum(
        stage.values())
    return {"device_busy_ms": busy, "stage_ms": stage,
            "stage_share": {k: v / busy for k, v in stage.items()}}


def _resolved(handles) -> list:
    """Each handle's chunk outputs; raises if a future failed."""
    return [h.future.result(timeout=600) for h in handles]


def _direct(module_builder, slot, *args):
    """One direct run of a zoo module, placed on its own on `slot`."""
    from repro_torch.core.module import AccelModule, run_placement
    pl = AccelModule("direct", module_builder, [1]).place(slot, 1)
    return run_placement(pl, *args)


def _chunk_ms(placement, args, reps=5) -> float:
    """Median time of one run_placement chunk, CUDA events on the slot's
    stream (its inputs' upload included), after one warm-up chunk."""
    from repro_torch.core.module import run_placement
    stream = placement.slot.stream
    run_placement(placement, *args)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        run_placement(placement, *args)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_daemon(smoke: Smoke) -> None:
    from repro_torch.core import Daemon, PolicyConfig, Shell, \
        default_registry, uniform_shell
    from repro_torch.core.slo import AdmissionRejected
    from repro_torch.launch.serve import DaemonServeRun, serve_daemon
    from repro_torch.obs import FlightRecorder
    res = smoke.results.setdefault("daemon", {})
    slot = Shell(uniform_shell("direct1_s1", (1, 1), 1)).slots[0]

    # (a) serve_daemon as the reference runs it, on one slot of the card,
    # with the flight recorder writing a Chrome trace
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "serve_daemon_trace.json"
        out = serve_daemon(DaemonServeRun(trace_out=str(trace_path)))
        trace = json.loads(trace_path.read_text())
    s = out["stats"]
    smoke.check("daemon: serve_daemon chunks", s["chunks"] == 14,
                f"{s['chunks']} (want 14)")
    rec = out["metrics"]["obs"]["counters"]
    smoke.check("daemon: --trace-out writes a Chrome trace whose chunk "
                "counts are the daemon's",
                bool(trace["traceEvents"])
                and rec["chunks_completed"] == s["chunks"]
                and rec["chunks_preempted"] == s["preemptions"],
                f"{len(trace['traceEvents'])} trace events, completed "
                f"{rec['chunks_completed']}, preempted "
                f"{rec['chunks_preempted']} (stats: chunks {s['chunks']}, "
                f"preemptions {s['preemptions']})")
    live = _resolved(out["handles"]["live"])
    batch = _resolved(out["handles"]["batch"])
    re_t, im_t = out["inputs"]["mandelbrot"]
    img = out["inputs"]["sobel"][0]
    mandel = _direct(zoo.build_mandelbrot, slot, re_t, im_t)
    edges = _direct(zoo.build_sobel, slot, img)
    smoke.check("daemon: every sobel output equals a direct run",
                all(torch.equal(o, edges) for (o,) in live), f"{len(live)}")
    smoke.check("daemon: every mandelbrot output equals a direct run",
                all(torch.equal(o, mandel) for outs in batch for o in outs),
                f"{sum(len(o) for o in batch)}")
    cpu = zoo.build_mandelbrot(None, 1).fn(None, torch.from_numpy(re_t),
                                           torch.from_numpy(im_t))
    differ = int((mandel.cpu() != cpu).sum())
    smoke.check("daemon: mandelbrot counts vs the CPU's (<= 1% of pixels)",
                differ <= 0.01 * cpu.numel(),
                f"{differ} of {cpu.numel()} pixels differ")
    res["serve_daemon"] = {
        "live_p95_ms": out["live_p95_ms"], "slo_misses": out["slo_misses"],
        "wall_s": out["wall_s"], "stats": s, "trace_counters": rec,
        "trace_events": len(trace["traceEvents"]),
        "sched_us_per_pass": s["sched_ns"] / max(1, s["sched_calls"]) / 1e3,
        "mandelbrot_pixels_differing_from_cpu": differ}
    print(f"   serve_daemon: live p95 {out['live_p95_ms']:.1f} ms, "
          f"{out['slo_misses']} SLO misses, wall {out['wall_s']:.3f} s, "
          f"stats {s}, scheduling "
          f"{res['serve_daemon']['sched_us_per_pass']:.1f} us a pass")

    # (b) the preemption recipe: saturate one slot, then a priority-5 job;
    # a flight recorder attached
    recorder = FlightRecorder(sample_every_ms=100.0)
    d = Daemon(Shell(uniform_shell("preempt1_s1", (1, 1), 1)),
               default_registry(), PolicyConfig(preemptive=True),
               obs=recorder)
    try:
        lo = d.submit("batch", "mandelbrot", [(re_t, im_t)] * 8, priority=0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:  # a chunk in flight, then 50 ms
            with d._lock:
                if d.state.active:
                    break
            time.sleep(0.005)
        time.sleep(0.05)
        hi = d.submit("live", "sobel", [(img,)], priority=5)
        (hi_out,), lo_outs = _resolved([hi, lo])
        st = dict(d.stats)
    finally:
        d.shutdown()
    smoke.check("daemon: preemption recipe preempts", st["preemptions"] >= 1,
                f"{st['preemptions']} preemptions")
    c = recorder.counts
    smoke.check("daemon: the recorder counts the recipe's chunks and "
                "preemptions", c["chunks_completed"] == st["chunks"]
                and c["chunks_preempted"] == st["preemptions"],
                f"completed {c['chunks_completed']}, preempted "
                f"{c['chunks_preempted']}")
    smoke.check("daemon: every preempted job's chunk resolves once, right",
                len(lo_outs) == 8 and st["chunks"] == 9
                and all(torch.equal(o, mandel) for o in lo_outs)
                and torch.equal(hi_out, edges), f"stats {st}")
    res["preemption"] = dict(st, recorder={
        k: c[k] for k in ("chunks_started", "chunks_completed",
                          "chunks_preempted")})

    # (c) the contract run
    out = serve_daemon(DaemonServeRun(contract=True))
    lv = out["slo"]["live"]
    counts = (lv["admitted"], lv["degraded"], lv["rejected"])
    smoke.check("daemon: contract admitted + degraded + rejected = 6",
                sum(counts) == 6, f"{counts}")
    rejected = [h for h in out["handles"]["live"]
                if h.future.exception() is not None]
    smoke.check("daemon: each rejected future raises AdmissionRejected",
                len(rejected) == lv["rejected"]
                and all(isinstance(h.future.exception(), AdmissionRejected)
                        for h in rejected), f"{len(rejected)} rejected")
    _resolved(out["handles"]["batch"])
    res["contract"] = {"admitted": counts[0], "degraded": counts[1],
                       "rejected": counts[2],
                       "attainment": lv["attainment"],
                       "live_p95_ms": out["live_p95_ms"]}
    print(f"   contract: {counts[0]} admitted / {counts[1]} degraded / "
          f"{counts[2]} rejected, attainment {lv['attainment']}")

    res["lm_forward_full"] = _lm_forward_full(smoke, slot, (re_t, im_t),
                                              (img,))
    gc.collect()                    # the full-width weights go here
    torch.cuda.empty_cache()
    res["lm_forward_full"]["flash_bf16_s64"] = _flash_lm_shape(smoke)


def _lm_forward_full(smoke, slot, mandel_args, sobel_args) -> dict:
    """(d): the lm-forward module at full width through the daemon."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import Daemon, ImplAlt, ModuleDescriptor, Shell, \
        default_registry, uniform_shell
    from repro_torch.core.module import AccelModule, run_placement
    from repro_torch.models import stack
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    cfg = configs.get(LLAMA)
    reg = default_registry()
    reg.register_module(ModuleDescriptor(
        "lm-forward-full", entrypoint="chip_smoke:build_lm_forward_full",
        impls=(ImplAlt("x1", 1, 20.0),)))
    shell = Shell(uniform_shell("lm1_s1", (1, 1), 1))
    d = Daemon(shell, reg)
    try:
        mod = d._module("lm-forward-full")
        t0 = time.perf_counter()
        mod.program(shell.slots[0], 1)
        host = mod.host_weights(1)        # the CPU init, timed on its own
        init_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size() for t in
                      _leaves(host))
        print(f"   lm-forward-full: CPU init of "
              f"{sum(t.numel() for t in _leaves(host)) / 1e9:.3f} B params "
              f"({n_bytes / 1e9:.2f} GB) in {init_s:.1f} s")
        tokens = np.random.default_rng(11).integers(
            0, cfg.vocab, (3, 8, 64), dtype=np.int32)
        _reset_launches()
        h = d.submit("lm", "lm-forward-full", [(t,) for t in tokens])
        (outs,) = _resolved([h])
        launches = _read_launches()
        st = dict(d.stats)
        (pl,) = d._placements.values()
    finally:
        d.shutdown()
    want = {"decode_attention": 0, "flash_attention": 28 * (3 + 1),
            "ssd_scan": 0}
    smoke.results.setdefault("launches", {})["daemon lm-forward-full"] = \
        launches
    _check_launches(smoke, "daemon lm-forward-full", launches, want)
    smoke.check("daemon lm-forward-full: one reconfiguration, two reuses",
                st["reconfigurations"] == 1 and st["reuses"] == 2,
                f"stats {st}")
    # the plain path on the same weights and tokens
    cfg_plain = dataclasses.replace(cfg, attn_impl="xla")
    rel, abs_err = [], []
    with torch.inference_mode():
        for toks, got in zip(tokens, outs):
            t = torch.from_numpy(toks).to(slot.device)
            hp, _ = stack.forward(pl.weights_on_slot, cfg_plain,
                                  {"tokens": t})
            want_l = stack.unembed(pl.weights_on_slot, cfg_plain,
                                   hp[:, -1:])[:, 0][:, :cfg.vocab]
            got_l = got[:, :cfg.vocab].float()
            rel.append(float((got_l - want_l).norm() / want_l.norm()))
            abs_err.append(float((got_l - want_l).abs().max()))
    smoke.check("daemon lm-forward-full: logits vs plain path "
                "(relative L2 <= 5e-2)",
                all(r <= 5e-2 for r in rel) and all(
                    bool(torch.isfinite(o).all()) for o in outs)
                and all(tuple(o.shape) == (8, cfg.padded_vocab)
                        for o in outs),
                f"relative L2 {max(rel):.3g}, max_abs_err {max(abs_err):.3g}")
    second = mod.place(pl.slot, 1)
    smoke.check("daemon lm-forward-full: a second placement is a cache hit",
                second.cache_hit, f"cache_hit={second.cache_hit}")
    del second
    lm = {"params": sum(t.numel() for t in _leaves(host)),
          "weight_bytes": n_bytes, "cpu_init_s": init_s,
          "compile_time_s": pl.compile_time_s, "load_time_s": pl.load_time_s,
          "upload_gb_per_s": n_bytes / pl.load_time_s / 1e9,
          "launches": launches, "stats": st, "relative_l2": rel,
          "max_abs_err": abs_err}
    print(f"   lm-forward-full: compile {pl.compile_time_s:.3f} s, load "
          f"{pl.load_time_s:.3f} s ({lm['upload_gb_per_s']:.2f} GB/s)")
    # each zoo module's chunk on the card, beside the registry's estimate
    chunk, placed = {}, {"lm-forward-full": (pl, (tokens[0],))}
    for name, builder, args in (
            ("mandelbrot", zoo.build_mandelbrot, mandel_args),
            ("sobel", zoo.build_sobel, sobel_args),
            ("matmul", zoo.build_matmul,
             (np.random.default_rng(12).standard_normal((512, 512))
              .astype(np.float32),))):
        placed[name] = (AccelModule(name, builder, [1]).place(slot, 1), args)
    for name, (placement, args) in placed.items():
        chunk[name] = _chunk_ms(placement, args)
    lm["chunk_ms"] = chunk
    lm["est_chunk_ms_x1"] = {"mandelbrot": 12.0, "sobel": 6.0,
                             "matmul": 4.0, "lm-forward": 20.0}
    print(f"   chunk ms on the card: {chunk}")
    # where a chunk's time goes: one chunk of the two slowest modules
    lm["profile"] = {
        f"{name} chunk": _profile(
            lambda: run_placement(placed[name][0], *placed[name][1]))
        for name in ("lm-forward-full", "mandelbrot")}
    return lm


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _flash_lm_shape(smoke) -> dict:
    """The flash kernel alone at the lm-forward module's attention shape
    (bf16, B=8, S=64, Hq=24, Hkv=8, hd=128, causal) beside one SDPA
    call in bf16 at the same shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    b, s, hq, hkv, hd = 8, 64, 24, 8, 128
    dt = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    q = _randn(gen, (b, s, hq, hd), dt)
    k = _randn(gen, (b, s, hkv, hd), dt)
    v = _randn(gen, (b, s, hkv, hd), dt)
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    err, ok = err_within(fa.flash_attention(q, k, v, causal=True),
                         fa.flash_attention_plain(q, k, v, causal=True),
                         TOL[dt])
    smoke.check("flash_attention bf16 at the lm-forward shape vs plain", ok,
                f"max_abs_err={err:.3g}")
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    flops = 4 * b * hq * hd * (s * (s + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dt] * 1e3
    device = device_time(lambda: fa.flash_attention(q, k, v, causal=True),
                         flush, "flash_kernel")
    return {"shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "hd": hd,
                      "dtype": "bfloat16"},
            "max_abs_err": err,
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                          flush),
            "device_ms": device[0],
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_ms(fn, flush, reps=30, warmup=3) -> float:
    """Median device time of fn() over `reps` runs, CUDA events around each
    run, the L2 cache flushed (a 256 MB write) before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time(fn, flush, kernel_name, calls=20, clean_l2=False) -> tuple:
    """Device-only time of one call of fn(): the self device time that
    torch.profiler gives the kernels whose name holds `kernel_name`, summed
    over `calls` calls (the L2 cache flushed before each) and divided by
    them, so the wrapper's host work is left out; and how many such device
    kernels one call enqueued, and the time of each of them by name.  The
    flush is time_ms's 256 MB write, which
    leaves the L2 full of dirty lines whose write-back the next kernel
    pays; with `clean_l2` it is a 256 MB read instead, which leaves clean
    lines, as the weight reads before attention in a decode step do."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if clean_l2:
                flush.sum()
            else:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and kernel_name in e.key and e.self_device_time_total]
    if not events:
        return "not measured", "not measured", {}
    by_kernel = {}
    for e in events:  # demangled name up to its argument list
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)
        by_kernel[name] = by_kernel.get(name, 0.0) + \
            e.self_device_time_total / 1e3 / calls
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls, by_kernel)


def _launches(smoke, path, name):
    """A kernel's launches in the main-path run that drives it."""
    return smoke.results.get("launches", {}).get(path, {}).get(name)


def phase_times(smoke: Smoke) -> None:
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    f32 = torch.float32
    cfg = _full_cfg(LLAMA, "pallas")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    kernels = []
    with torch.inference_mode():
        # decode: a mid-run step of the serving path; nested, the same at
        # jamba's and qwen3-moe's groupings (g=4 on 8 kv heads, g=8 on 4)
        # and at whisper's and phi-3-vision's MHA heads (hd 64 and 96)
        kernels.append(_decode_entry(smoke, gen, flush, hq, hkv, hd, LLAMA))
        for arch in (JAMBA, QWEN_MOE, WHISPER, PHI3V):
            c = _full_cfg(arch, "pallas")
            kernels[-1][arch] = _decode_entry(smoke, gen, flush, c.n_heads,
                                              c.n_kv_heads, c.head_dim, arch)
        # flash: the full-width cache-free forward's attention, in fp32 (the
        # main path) and in bf16 (nested in the fp32 entry), and in fp32 at
        # jamba's, qwen3-moe's, whisper's and phi-3-vision's heads (nested)
        kernels.append(_flash_entry(smoke, gen, flush, hq, hkv, hd, scale,
                                    f32))
        kernels[-1]["bf16"] = _flash_entry(smoke, gen, flush, hq, hkv, hd,
                                           scale, torch.bfloat16)
        for arch in (JAMBA, QWEN_MOE, WHISPER, PHI3V):
            c = _full_cfg(arch, "pallas")
            kernels[-1][arch] = _flash_entry(
                smoke, gen, flush, c.n_heads, c.n_kv_heads, c.head_dim,
                c.head_dim ** -0.5, f32, arch)
        # ssd_scan: one layer of the full-width mamba2-780m prefill, and
        # (nested) of jamba's
        kernels.append(_ssd_entry(smoke, gen, flush, MAMBA))
        kernels[-1][JAMBA] = _ssd_entry(smoke, gen, flush, JAMBA)
        for entry in kernels:       # every main-path run that launched it
            entry["launches_by_path"] = {
                path: counts[entry["name"]] for path, counts in
                smoke.results.get("launches", {}).items()
                if counts.get(entry["name"])}
        smoke.results["kernels"] = kernels
    for arch in (LLAMA, MAMBA):
        _model_times(smoke, flush, arch)


def _decode_entry(smoke, gen, flush, hq, hkv, hd, arch) -> dict:
    """The decode kernel's `kernels`-line entry at a mid-run step of
    serving `arch` (cache 1056 rows, 1040 valid), fp32."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    f32, scale = torch.float32, hd ** -0.5
    s_cache, length = PROMPT + NEW, PROMPT + NEW // 2
    q = _randn(gen, (BATCH, hq, hd), f32)
    k = _randn(gen, (BATCH, s_cache, hkv, hd), f32)
    v = _randn(gen, (BATCH, s_cache, hkv, hd), f32)
    kq, kk, kv = (q[:, :, None], k[:, :length].transpose(1, 2),
                  v[:, :length].transpose(1, 2))
    got = da.decode_attention(q, k, v, length, scale=scale)
    want = da.decode_attention_plain(q, k, v, length, scale=scale)
    nbytes = 4 * (2 * BATCH * length * hkv * hd + 2 * BATCH * hq * hd)
    flops = 4 * BATCH * hq * length * hd
    return _kernel_entry(
        "decode_attention",
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:63",
        smoke, _launches(smoke, f"serve {arch}", "decode_attention"),
        got, want,
        time_ms(lambda: da.decode_attention(q, k, v, length, scale=scale),
                flush),
        time_ms(lambda: da.decode_attention_plain(q, k, v, length,
                                                  scale=scale), flush),
        time_ms(lambda: F.scaled_dot_product_attention(
            kq, kk, kv, scale=scale, enable_gqa=True), flush),
        [device_time(lambda: da.decode_attention(q, k, v, length,
                                                 scale=scale),
                     flush, "decode_kernel", clean_l2=clean)
         for clean in (False, True)],
        nbytes, flops,
        {"b": BATCH, "hq": hq, "hkv": hkv, "hd": hd, "s_cache": s_cache,
         "length": length, "dtype": "float32"})


def _ssd_entry(smoke, gen, flush, arch) -> dict:
    """The SSD kernel's `kernels`-line entry at one layer of `arch`'s
    full-width prefill, seeded from the (zero) cache state as the serving
    path seeds it."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    f32 = torch.float32
    ms = _full_cfg(arch, "pallas").mamba_spec
    h, p, g, n, chunk = (ms.n_heads, ms.headdim, ms.n_groups, ms.d_state,
                         ms.chunk)
    args = _ssd_inputs(gen, BATCH, PROMPT, h, p, g, n, f32)
    init = torch.zeros((BATCH, h, p, n), device=DEVICE)
    got = ssd.ssd(*args, chunk=chunk, impl="pallas", initial_state=init)
    want = ssd.ssd(*args, chunk=chunk, impl="xla", initial_state=init)
    err_s, ok_s = err_within(got[1], want[1], SSD_TOL[f32][1])
    smoke.check(f"ssd_scan: timed inputs vs plain (state) h={h} n={n}", ok_s,
                f"max_abs_err={err_s:.3g}")
    # x, dt, B, C and the initial state read once, y and the state written
    # once
    nbytes = 4 * (2 * BATCH * PROMPT * h * p + BATCH * PROMPT * h
                  + 2 * BATCH * PROMPT * g * n + h + 2 * BATCH * h * p * n)
    # per chunk: C.B^T over the causal triangle once per (batch, group),
    # the score.x product over the triangle, C.S and the state update per
    # (batch, head)
    tri = chunk * (chunk + 1) // 2
    n_chunks = -(-PROMPT // chunk)
    flops = n_chunks * BATCH * (2 * n * tri * g
                                + h * (2 * p * tri + 4 * chunk * n * p))
    return _kernel_entry(
        "ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:69",
        smoke, _launches(smoke, f"serve {arch}", "ssd_scan"),
        got[0], want[0],
        time_ms(lambda: ssd.ssd(*args, chunk=chunk, impl="pallas",
                                initial_state=init), flush),
        time_ms(lambda: ssd.ssd(*args, chunk=chunk, impl="xla",
                                initial_state=init), flush, reps=20),
        None,
        # all four phases' kernels (ssd_cb, ssd_chunk_state,
        # ssd_state_pass, ssd_chunk_scan)
        [device_time(lambda: ssd.ssd(*args, chunk=chunk, impl="pallas",
                                     initial_state=init),
                     flush, "ssd_", clean_l2=clean)
         for clean in (False, True)],
        nbytes, flops,
        {"b": BATCH, "L": PROMPT, "h": h, "p": p, "g": g, "n": n,
         "chunk": chunk, "dtype": "float32"},
        library_note="none: no single PyTorch call computes an SSD scan")


def _flash_entry(smoke, gen, flush, hq, hkv, hd, scale, dtype,
                 arch=LLAMA) -> dict:
    """The flash kernel's `kernels`-line entry at the full-width forward
    shape of `arch` (llama3.2-3b's by default) in `dtype`."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    q = _randn(gen, (BATCH, PROMPT, hq, hd), dtype)
    k = _randn(gen, (BATCH, PROMPT, hkv, hd), dtype)
    v = _randn(gen, (BATCH, PROMPT, hkv, hd), dtype)
    got = fa.flash_attention(q, k, v, causal=True, scale=scale)
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=scale)
    nbytes = q.element_size() * (2 * BATCH * PROMPT * hq * hd
                                 + 2 * BATCH * PROMPT * hkv * hd)
    flops = 4 * BATCH * hq * hd * (PROMPT * (PROMPT + 1) // 2)
    return _kernel_entry(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:79",
        smoke, _launches(smoke, f"forward {arch}", "flash_attention"),
        got, want,
        time_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                           scale=scale), flush),
        time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                 scale=scale), flush),
        time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale, enable_gqa=True), flush),
        [device_time(lambda: fa.flash_attention(q, k, v, causal=True,
                                                scale=scale),
                     flush, "flash_kernel", clean_l2=clean)
         for clean in (False, True)],
        nbytes, flops,
        {"b": BATCH, "s": PROMPT, "hq": hq, "hkv": hkv, "hd": hd,
         "dtype": str(dtype).removeprefix("torch.")}, dtype=dtype)


def _model_times(smoke, flush, arch) -> None:
    """Prefill and decode-step times of one model on the kernel path at full
    width, and where the time goes (torch.profiler over one prefill and over
    three decode steps).  The kernels' end-to-end counterparts: for
    mamba2-780m the prefill with the plain SSD scan; for llama3.2-3b the
    cache-free forward (the flash kernel's path) on the kernel and with
    plain attention."""
    import dataclasses
    from repro_torch.models import io, stack
    cfg = _full_cfg(arch, "pallas")
    with torch.inference_mode():
        params = _params(cfg)
        batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                              torch.Generator(device=DEVICE).manual_seed(1))
        prefill = stack.build_prefill_fn(cfg, PROMPT + NEW)
        times = {"prefill_ms": time_ms(lambda: prefill(params, batch), flush,
                                       reps=20, warmup=2)}
        if arch == MAMBA:
            plain = stack.build_prefill_fn(
                dataclasses.replace(cfg, ssd_impl="xla"), PROMPT + NEW)
            times["prefill_ms_plain_ssd"] = time_ms(
                lambda: plain(params, batch), flush, reps=10, warmup=1)
        else:
            fwd = {"tokens": batch["tokens"]}
            cfg_plain = dataclasses.replace(cfg, attn_impl="xla")
            times["forward_ms"] = time_ms(
                lambda: stack.forward(params, cfg, fwd), flush, reps=10,
                warmup=1)
            times["forward_ms_plain_attn"] = time_ms(
                lambda: stack.forward(params, cfg_plain, fwd), flush,
                reps=10, warmup=1)
        cache, logits = prefill(params, batch)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        decode = stack.build_decode_fn(cfg)
        steps = []
        for i in range(NEW - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cache, nxt, _ = decode(params, cache, tok, PROMPT + i)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
            tok = nxt[:, None]
        step_ms = statistics.median(steps[1:])
        times.update({"decode_step_ms": step_ms,
                      "decode_tok_per_s": BATCH * 1e3 / step_ms,
                      "decode_steps_timed": len(steps) - 1})
        smoke.results.setdefault("times", {})[arch] = times

        def three_steps():
            c, t = cache, tok
            for i in range(3):
                c, n, _ = decode(params, c, t, PROMPT + NEW - 4 + i)
                t = n[:, None]
        smoke.results.setdefault("profile", {})[arch] = {
            "prefill": _profile(lambda: prefill(params, batch)),
            "decode_3_steps": _profile(three_steps)}


def _profile(fn) -> dict:
    """Host wall time of fn() under torch.profiler, the device time its
    kernels took (one stream, so their sum is the busy time), the idle
    share, and the kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_calls": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _kernel_entry(name, source, replaces, smoke, launches, got, want, ms,
                  plain_ms, library_ms, device, nbytes, flops, shape,
                  library_note=None, dtype=torch.float32):
    """One entry of the `kernels` line; checks the timed inputs' output
    against the plain version at `dtype`'s tolerance.  `device` holds
    device_time()'s (ms, device kernels per call) after the write flush
    and after the read flush.  The operations bound is at FLOP_PER_S of
    `dtype`; the bound at the fp32 rate outside the tensor cores is kept
    beside it."""
    err, ok = err_within(got, want, TOL[dtype])
    smoke.check(f"{name}: timed inputs vs plain ({shape['dtype']})", ok,
                f"max_abs_err={err:.3g}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dtype] * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "device_ms": device[0][0],
            "device_ms_clean_l2": device[1][0],
            "device_kernels_per_call": device[0][1],
            "device_ms_by_kernel": device[0][2], "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_fp32_fma": max(t_bytes,
                                     flops / FP32_FLOP_PER_S * 1e3),
            "library_ms": library_ms,
            **({"library_note": library_note} if library_note else {}),
            "shape": shape, "bytes": nbytes, "flops": flops}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    smoke = Smoke()
    t0 = time.perf_counter()
    smoke.phase("1 setup and build", lambda: phase_setup(smoke))
    smoke.phase("2 kernels vs plain", lambda: phase_kernels(smoke))
    smoke.phase(f"3 serve {LLAMA} at full width",
                lambda: phase_serve(smoke, LLAMA))
    smoke.phase(f"4 forward {LLAMA} at full width",
                lambda: phase_forward(smoke, LLAMA))
    smoke.phase(f"5 serve {MAMBA} at full width",
                lambda: phase_serve(smoke, MAMBA))
    smoke.phase(f"6 forward {MAMBA} at full width",
                lambda: phase_forward(smoke, MAMBA))
    smoke.phase("8 FOS daemon on the card", lambda: phase_daemon(smoke))
    smoke.phase(f"9 {JAMBA} cut to {DEPTH_CUT[JAMBA]} layers at full width",
                lambda: phase_moe_model(smoke, JAMBA))
    smoke.phase(f"10 {QWEN_MOE} cut to {DEPTH_CUT[QWEN_MOE]} layers at full "
                f"width", lambda: phase_moe_model(smoke, QWEN_MOE))
    smoke.phase(f"11 {WHISPER} at full width and depth",
                lambda: phase_encdec_vlm(smoke, WHISPER))
    smoke.phase(f"12 {PHI3V} at full width and depth",
                lambda: phase_encdec_vlm(smoke, PHI3V))
    smoke.phase("7 times", lambda: phase_times(smoke))
    r = smoke.results
    for key in ("launches", "serve", "forward", "times", "profile",
                "daemon", "moe_models", "decode_g1", "phases"):
        if key in r:
            print(json.dumps({key: r[key]}))
    print(f"total {time.perf_counter() - t0:.1f} s; "
          f"failures: {smoke.failures or 'none'}")
    if smoke.failures or "kernels" not in r:
        return 1
    print(json.dumps({"kernels": r["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
