"""Tour of the FOS logical-hardware abstraction (paper Listings 1-5).

Shows the JSON descriptors for shells and accelerators, decoupled
compilation against a slot interface, relocation to a congruent slot,
slot merging for a bigger implementation alternative, and the generic
driver invoking a module purely from its descriptor.

    PYTHONPATH=src python -m repro_torch.examples.fos_registry_tour \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import Shell, default_registry, uniform_shell
from repro_torch.core.module import AccelModule, run_placement
from repro_torch.models.api import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reg = default_registry()

    print("== shell descriptor (paper Listing 1) ==")
    print(json.dumps(reg.shell("pod256_s4").to_json(), indent=2)[:400])

    print("\n== accelerator descriptor (paper Listing 2) ==")
    print(json.dumps(reg.module("mandelbrot").to_json(), indent=2))

    # single-device shell for the live part
    shell = Shell(uniform_shell("host1_s1", (1, 1), 1), devices=[device])
    desc = reg.module("mandelbrot")
    mod = AccelModule("mandelbrot", desc.load_builder(), desc.footprints)

    print("\n== decoupled compilation against the slot interface ==")
    t0 = time.perf_counter()
    pl = mod.place(shell.slots[0], 1)
    print(f"first compile: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(cache_hit={pl.cache_hit})")

    t0 = time.perf_counter()
    pl2 = mod.place(shell.slots[0], 1)
    print(f"relocation (congruent slot): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(cache_hit={pl2.cache_hit})")

    print("\n== generic driver invocation (paper Listings 4/5) ==")
    rng = np.random.default_rng(0)
    re = rng.uniform(-2, 1, (256, 256)).astype(np.float32)
    im = rng.uniform(-1.5, 1.5, (256, 256)).astype(np.float32)
    out = torch.as_tensor(run_placement(pl2, re, im)).cpu().numpy()
    print(f"mandelbrot tile -> {out.shape}, "
          f"mean escape iter {float(out.mean()):.1f}")

    print("\n== module I/O signature (the ADR-map analogue) ==")
    prog = mod.program(shell.slots[0], 1)
    print(json.dumps(prog.signature(), indent=2)[:400])
    return {"escape": out, "signature": prog.signature()}


if __name__ == "__main__":
    main()
