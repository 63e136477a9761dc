"""Quickstart: train a reduced model for a few steps, then serve it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch qwen3-14b] [--device cpu]

Every assigned architecture works (reduced configs).  On the card the
served decode steps run the decode-attention kernel.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.launch.serve import ServeRun, serve
from repro_torch.launch.train import TrainRun, train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"== training {args.arch} (reduced) for {args.steps} steps ==")
    hist = train(TrainRun(arch=args.arch, steps=args.steps, global_batch=8,
                          seq_len=32, lr=3e-3, log_every=5,
                          device=args.device))
    first, last = hist["loss"][0][1], hist["loss"][-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({hist['steps_per_sec']:.2f} steps/s)")

    print(f"== serving {args.arch} (reduced): prefill + 16 tokens ==")
    served = serve(ServeRun(arch=args.arch, batch=2, prompt_len=16,
                            max_new_tokens=16, device=args.device))
    return {"train": hist, "serve": served}


if __name__ == "__main__":
    main()
