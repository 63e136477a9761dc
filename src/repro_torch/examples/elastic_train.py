"""Elastic, fault-tolerant training end to end.

Demonstrates the FOS replacement primitive applied to a training job:
  1. train with async checkpointing;
  2. inject a fault mid-run -> supervisor restarts from the checkpoint;
  3. elastic re-partition mid-run (the scheduler re-allocating slots):
     save -> rebuild with different partitioning rules -> elastic restore.

    PYTHONPATH=src python -m repro_torch.examples.elastic_train \
        [--steps 60] [--m100] [--device cpu]

--m100 trains a ~100M-parameter llama-style config (8 layers, d_model
768; slow on the CPU; the default is the reduced config so the demo
finishes in seconds).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
import types

from repro_torch.launch.train import TrainRun, train


def register_m100():
    """Register the ~100M config, based on llama3.2-3b, as "llama-100m" in
    the port's config table; returns it."""
    from repro_torch import configs as cfgs
    from repro_torch.models import api
    base = cfgs.get("llama3.2-3b")
    cfg = dataclasses.replace(
        base, name="llama-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000)
    print(f"~100M config: {api.param_count(cfg) / 1e6:.0f}M params")
    cfgs._MODULES["llama-100m"] = "llama_100m"
    sys.modules["repro_torch.configs.llama_100m"] = types.SimpleNamespace(
        CONFIG=cfg, REDUCED=cfg)
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--m100", action="store_true",
                    help="~100M-param config (CPU-slow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.m100:
        register_m100()
        arch, reduced, batch, seq = "llama-100m", False, 4, 256
    else:
        arch, reduced, batch, seq = "llama3.2-3b", True, 8, 64

    with tempfile.TemporaryDirectory() as ckdir:
        hist = train(TrainRun(
            arch=arch, reduced=reduced, steps=args.steps,
            global_batch=batch, seq_len=seq, lr=3e-3,
            ckpt_dir=ckdir, ckpt_every=10,
            fail_at_step=args.steps // 3,          # injected fault
            elastic_switch_step=2 * args.steps // 3,  # re-partition
            log_every=10, device=args.device))
    print(f"done: steps={hist['final_step']} restarts={hist['restarts']} "
          f"elastic_switches={hist['elastic_switches']} "
          f"loss {hist['loss'][0][1]:.3f} -> {hist['loss'][-1][1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
