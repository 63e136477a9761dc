#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check makes the exit code non-zero and keeps
the final `{"ok": true, ...}` line from printing:
  1. report the card (nvidia-smi name and power limit), turn TF32 off for
     matmuls and cuDNN, build the CUDA kernels from the sources (timed);
     fail on a register spill in a main-path instantiation; count the HMMA
     (tensor-core) instructions of the hd=128 flash kernels where the
     toolkit has cuobjdump;
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
     carried state;
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
     attention, and a torch.profiler breakdown.
Each of phases 3-6 sets every launch count to 0 just before it drives the
path and reads the counts just after.  Then the `kernels` JSON line, the
card line and the final line.

It imports nothing of jax or of the reference package `repro`.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

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
LAYERS = {LLAMA: 28, MAMBA: 48}
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
]
# (b, L, h, p, g, n, chunk): the full-width mamba2-780m prefill shape
SSD_FULL = (4, 1024, 48, 64, 1, 128, 128)
# the reference's SSD_CASES, the reduced mamba2-780m shape, then the
# full-width prefill shape, a ragged L=1000 and L=4096 (32 chunks)
SSD_CASES = [
    (1, 256, 2, 64, 1, 64, 64), (2, 128, 4, 32, 2, 16, 32),
    (1, 512, 2, 64, 1, 128, 128), (1, 128, 2, 64, 1, 16, 64),
    (2, 20, 8, 16, 1, 16, 16),
    SSD_FULL, (4, 1000, 48, 64, 1, 128, 128), (4, 4096, 48, 64, 1, 128, 128),
]
# the kernel instantiations the fp32 main paths run, as ptxas names them
# (mangled): decode at hd=128, g<=4; SSD at P=64, N=128 (its C.B^T kernel
# at N=128); flash at hd=128
FLASH_MAIN = "flash_kernelIfLi128E"
MAIN_PATH_INSTANCES = (
    "decode_kernelIfLi128ELi4E", "ssd_chunk_state_kernelIfLi64ELi128E",
    "ssd_chunk_scan_kernelIfLi64ELi128E", "ssd_cb_kernelIfLi128E",
    "ssd_state_pass_kernel", FLASH_MAIN)
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
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc()
            self.check(f"{name}: raised", False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"   {name}: {time.perf_counter() - t0:.1f} s", flush=True)


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
    smoke.check("ptxas: main-path instantiations do not spill",
                bool(main_path) and not any(k["spill"] for k in main_path),
                f"{len(main_path)} kernels")
    # the flash kernel's products run on the tensor cores: HMMA in its SASS
    for inst in (FLASH_MAIN, "flash_kernelI13__nv_bfloat16Li128E"):
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
    """Each entry function of a `-Xptxas -v` log, with its registers and
    spill stores."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append({"name": m.group(1), "registers": 0, "spill": 0})
        elif kernels and (m := re.search(r"(\d+) bytes spill stores", line)):
            kernels[-1]["spill"] = int(m.group(1))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
    return kernels


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
    # a peaky softmax: the full-width shape with inputs x3 (scores x9), where
    # fp32 itself drifts from the exact result.  The kernel keeps fp32's
    # accuracy if its error against an fp64 computation is at most twice
    # the plain fp32 version's
    q, k, v = (3 * _randn(gen, (4, 1024, h, 128), torch.float32)
               for h in (24, 8, 8))
    exact = _attention_fp64(q, k, v)
    err_kernel = float((fa.flash_attention(q, k, v, causal=True).double()
                        - exact).abs().max())
    err_plain = float((fa.flash_attention_plain(q, k, v, causal=True)
                       .double() - exact).abs().max())
    smoke.check("flash_attention inputs x3 float32: error vs fp64 within 2x "
                "the plain fp32 version's", err_kernel <= 2 * err_plain,
                f"kernel {err_kernel:.3g}, plain fp32 {err_plain:.3g}")
    for b, l, h, p, g, n, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(gen, b, l, h, p, g, n, dtype)
            got = ssd.ssd(*args, chunk=chunk, impl="pallas")
            want = ssd.ssd(*args, chunk=chunk, impl="xla")
            torch.cuda.synchronize()
            _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} n={n} "
                       f"chunk={chunk} {dtype}", got, want, dtype)
    # the full-width shape at the model's decay and step ranges, where the
    # state is carried across whole chunks
    b, l, h, p, g, n, chunk = SSD_FULL
    for dtype in (torch.float32, torch.bfloat16):
        args = _ssd_model_inputs(gen, b, l, h, p, g, n, dtype)
        got = ssd.ssd(*args, chunk=chunk, impl="pallas")
        want = ssd.ssd(*args, chunk=chunk, impl="xla")
        torch.cuda.synchronize()
        _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} n={n} "
                   f"chunk={chunk} model ranges {dtype}", got, want, dtype)
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
    to `impl`."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), param_dtype=torch.float32,
                               compute_dtype=torch.float32,
                               kv_dtype=torch.float32, attn_impl=impl,
                               ssd_impl=impl)


def _params(cfg, seed=0):
    from repro_torch.models import api
    return api.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(seed))


def phase_serve(smoke: Smoke, arch: str) -> None:
    from repro_torch.launch.serve import ServeRun, serve
    from repro_torch.models import stack
    layers = LAYERS[arch]
    run = ServeRun(arch=arch, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    _reset_launches()
    out = serve(run)
    launches = _read_launches()
    # llama: the decode kernel at every layer of every decode step (prefill
    # attends through plain _sdpa, as the reference); mamba: the SSD scan at
    # every layer of the prefill (its decode step is plain torch)
    want = ({"decode_attention": layers * (NEW - 1), "flash_attention": 0,
             "ssd_scan": 0} if arch == LLAMA else
            {"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers})
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
    prompt = out["prompt"]
    toks = tokens.to(prompt.device, torch.int32)
    with torch.inference_mode():
        cache, plain = stack.build_prefill_fn(cfg, PROMPT + NEW)(
            params, {"tokens": prompt})
        plain_logits = [plain]
        decode = stack.build_decode_fn(cfg)
        for i in range(NEW - 1):
            cache, _, lg = decode(params, cache, toks[:, i:i + 1], PROMPT + i)
            plain_logits.append(lg)
    plain = torch.stack(plain_logits, dim=1)
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3))
    smoke.results.setdefault("serve", {})[arch] = {
        "batch": BATCH, "prompt_len": PROMPT, "new_tokens": NEW,
        "prefill_s": out["prefill_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "launches": launches, "max_abs_logit_err_vs_plain": err}
    smoke.check(f"serve {arch}: logits vs plain path (atol=rtol=1e-3)", ok,
                f"max_abs_err={err:.3g}")


def phase_forward(smoke: Smoke, arch: str) -> None:
    from repro_torch.models import stack
    layers = LAYERS[arch]
    cfg_k, cfg_p = _full_cfg(arch, "pallas"), _full_cfg(arch, "xla")
    params = _params(cfg_p)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg_p.vocab, (BATCH, PROMPT), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        _reset_launches()
        h, _ = stack.forward(params, cfg_k, {"tokens": tokens})
        launches = _read_launches()
        h_plain, _ = stack.forward(params, cfg_p, {"tokens": tokens})
    want = ({"decode_attention": 0, "flash_attention": layers,
             "ssd_scan": 0} if arch == LLAMA else
            {"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers})
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
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.ssd_scan import ops as ssd
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    f32 = torch.float32
    cfg = _full_cfg(LLAMA, "pallas")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    kernels = []
    with torch.inference_mode():
        # decode: a mid-run step of the serving path
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
        kernels.append(_kernel_entry(
            "decode_attention",
            "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:63",
            smoke, _launches(smoke, f"serve {LLAMA}", "decode_attention"),
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
             "length": length, "dtype": "float32"}))
        # flash: the full-width cache-free forward's attention, in fp32 (the
        # main path) and in bf16 (nested in the fp32 entry)
        del q, k, v, kq, kk, kv, got, want
        kernels.append(_flash_entry(smoke, gen, flush, hq, hkv, hd, scale,
                                    f32))
        kernels[-1]["bf16"] = _flash_entry(smoke, gen, flush, hq, hkv, hd,
                                           scale, torch.bfloat16)
        # ssd_scan: one layer of the full-width mamba2-780m prefill, seeded
        # from the (zero) cache state as the serving path seeds it
        ms = _full_cfg(MAMBA, "pallas").mamba_spec
        h, p, g, n, chunk = (ms.n_heads, ms.headdim, ms.n_groups,
                             ms.d_state, ms.chunk)
        args = _ssd_inputs(gen, BATCH, PROMPT, h, p, g, n, f32)
        init = torch.zeros((BATCH, h, p, n), device=DEVICE)
        got = ssd.ssd(*args, chunk=chunk, impl="pallas", initial_state=init)
        want = ssd.ssd(*args, chunk=chunk, impl="xla", initial_state=init)
        err_s, ok_s = err_within(got[1], want[1], SSD_TOL[f32][1])
        smoke.check("ssd_scan: timed inputs vs plain (state)", ok_s,
                    f"max_abs_err={err_s:.3g}")
        # x, dt, B, C and the initial state read once, y and the state
        # written once
        nbytes = 4 * (2 * BATCH * PROMPT * h * p + BATCH * PROMPT * h
                      + 2 * BATCH * PROMPT * g * n + h + 2 * BATCH * h * p * n)
        # per chunk: C.B^T over the causal triangle once per (batch,
        # group), the score.x product over the triangle, C.S and the state
        # update per (batch, head)
        tri = chunk * (chunk + 1) // 2
        n_chunks = -(-PROMPT // chunk)
        flops = n_chunks * BATCH * (2 * n * tri * g
                                    + h * (2 * p * tri + 4 * chunk * n * p))
        kernels.append(_kernel_entry(
            "ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/ssd_scan.py:69",
            smoke, _launches(smoke, f"serve {MAMBA}", "ssd_scan"),
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
            library_note="none: no single PyTorch call computes an SSD scan"))
        del args, init, got, want
        smoke.results["kernels"] = kernels
    for arch in (LLAMA, MAMBA):
        _model_times(smoke, flush, arch)


def _flash_entry(smoke, gen, flush, hq, hkv, hd, scale, dtype) -> dict:
    """The flash kernel's `kernels`-line entry at the llama3.2-3b forward
    shape in `dtype`."""
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
        smoke, _launches(smoke, f"forward {LLAMA}", "flash_attention"),
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
    smoke.phase("7 times", lambda: phase_times(smoke))
    r = smoke.results
    for key in ("launches", "serve", "forward", "times", "profile"):
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
