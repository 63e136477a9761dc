#!/usr/bin/env python3
"""Where the bf16 flash kernel's time goes, on one NVIDIA GPU.

    python3 tools/flash_variants.py

Builds copies of `src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu` into `build/flash_variants/`, each changed in one way:

- `kept`: the source as it is;
- `w2`: two consumer warpgroups a CTA (128 query rows, one CTA an SM);
- `one_pass`: P.V without its P_lo pass (P rounded once to bf16);
- `no_softmax`: the softmax left out (P = the raw scores, O not rescaled);
- `no_pv`, `no_qk`: the P.V or the Q.K^T wgmma left out;
- `no_kv_loads`: K and V loaded for the first two tiles only (later tiles
  reuse the stale stages).

All but `kept` and `w2` compute wrong results on purpose: they time the
kernel with one part of its work gone.  Each runs in its own process (a
timeout guards against a hang) and is timed with `chip_smoke.device_time`
(CUDA events behind a `torch.cuda._sleep` spin, the L2 flushed before each
call) at llama3.2-3b's forward shape (B=4, S=1024, 24/8 heads of 128) and
the lm-forward module's (B=8, S=64), beside
`F.scaled_dot_product_attention` at the same inputs.  Prints one JSON line
a variant (`{"variant": ..., "ms": {...}, "max_abs_err": {...}}`), ptxas's
registers, spills and wgmma-serialization notes for the hd=128 instance,
and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"
SHAPES = {"llama": (4, 1024, 24, 8, 128), "lm_forward": (8, 64, 24, 8, 128)}

# (old, new) text replacements that make each variant
PATCHES = {
    "kept": [],
    "w2": [("constexpr int kW = 1;", "constexpr int kW = 2;")],
    "one_pass": [(
        "#pragma unroll\n  for (int kk = 0; kk < 4; ++kk)\n"
        "    wgmma_rs<HD>(o, *reinterpret_cast<const uint32_t(*)[4]>"
        "(plo + 4 * kk),\n                 dv + ((kk * 16 * SWB) >> 4));\n",
        "")],
    "no_softmax": [(
        "  const bool edge = k0 + 63 > q0w || k0 + 64 > sk;",
        "  alpha[0] = alpha[1] = 1.f;\n#if 0"), (
        "  // the A fragment of P.V's k-step kk", "#endif\n"
        "  // the A fragment of P.V's k-step kk")],
    "no_pv": [(
        "    wgmma_rs<HD>(o, *reinterpret_cast<const uint32_t(*)[4]>"
        "(plo + 4 * kk),\n                 dv + ((kk * 16 * SWB) >> 4));\n",
        "    ;\n"), (
        "    wgmma_rs<HD>(o, *reinterpret_cast<const uint32_t(*)[4]>"
        "(phi + 4 * kk),\n                 dv + ((kk * 16 * SWB) >> 4));\n",
        "    ;\n")],
    "no_qk": [(
        "    wgmma_ss_n64(sc, dq + ((c * C::kQChunk + x) >> 4),\n"
        "                 dk + ((c * 64 * C::SWB + x) >> 4), kk > 0);\n",
        "    (void)c, (void)x;\n")],
    "no_kv_loads": [(
        "        mbar_expect_tx(k_full(s), C::kTile);\n",
        "        if (t >= kStages) { mbar_arrive(k_full(s)); } else {\n"
        "        mbar_expect_tx(k_full(s), C::kTile);\n"), (
        "                   kvh, 64 * t, b);\n        if (round > 0)",
        "                   kvh, 64 * t, b);\n        }\n"
        "        if (round > 0)"), (
        "        mbar_expect_tx(v_full(s), C::kTile);\n",
        "        if (t >= kStages) { mbar_arrive(v_full(s)); } else {\n"
        "        mbar_expect_tx(v_full(s), C::kTile);\n"), (
        "                   kvh, 64 * t, b);\n      }\n    }\n  } else {",
        "                   kvh, 64 * t, b);\n        }\n      }\n    }\n"
        "  } else {")],
}


def build() -> dict:
    """Compile every variant in parallel; their libraries and ptxas notes."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in PATCHES.items():
        text = SRC.read_text()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: the source changed; patch not "
                                 f"found: {old[:60]!r}")
            text = text.replace(old, new, 1)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        lib = OUT / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    notes = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        notes[name] = {"rc": proc.returncode, **_ptxas_128(log)}
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
    return notes


def _ptxas_128(log: str) -> dict:
    """Registers, spill stores and serialization notes of the hd=128
    instance of the wgmma kernel in a `-Xptxas -v` log."""
    out, inside = {"serialized": set()}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "flash_wgmma_kernelILi128E" in line
        elif inside and (m := re.search(r"Used (\d+) registers", line)):
            out["registers"] = int(m.group(1))
        elif inside and (m := re.search(r"(\d+) bytes spill stores", line)):
            out["spill_stores"] = int(m.group(1))
        if m := re.search(r"\((C75\d\d)\) Potential Performance Loss", line):
            out["serialized"].add(m.group(1))
    out["serialized"] = sorted(out["serialized"])
    return out


def run(name: str) -> None:
    """Time one variant (in its own process)."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels.flash_attention import ops as fa
    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    fa._bind(lib)
    fa._lib = lambda: lib
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 * 2 ** 20, device="cuda")
    ms, err = {}, {}
    for shape, (b, s, hq, hkv, hd) in SHAPES.items():
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .bfloat16() for h in (hq, hkv, hkv))
        err[shape] = float((fa.flash_attention(q, k, v).float()
                            - fa.flash_attention_plain(q, k, v).float())
                           .abs().max())
        ms[shape] = chip_smoke.device_time(
            lambda: fa.flash_attention(q, k, v), flush)["ms"]
        ms[f"{shape}_sdpa"] = chip_smoke.device_time(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), flush)["ms"]
    print(json.dumps({"variant": name, "ms": ms, "max_abs_err": err}),
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    notes = build()
    for name in PATCHES:
        print(json.dumps({"variant": name, "ptxas": notes[name]}),
              flush=True)
        if notes[name]["rc"]:
            continue
        try:
            subprocess.run([sys.executable, __file__, "--run", name],
                           timeout=120, check=False)
        except subprocess.TimeoutExpired:
            print(json.dumps({"variant": name, "error": "timeout"}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
