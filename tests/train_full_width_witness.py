"""The reference's own loss trajectory at llama3.2-3b's full width.

`chip_smoke.py` phase 13 (a) trains llama3.2-3b at full width and depth
(B=2, S=512, 8 steps, lr 1e-3, warm-up 5, the driver's cosine over 10
steps), and a fresh batch's loss there rises above ln V = 11.7618 over
the 8 steps instead of falling.  This script shows that the reference
does the same at that width: the port's step and the reference's
unsharded step (jitted, no mesh) take the same 8 steps from the same
weights (`chip_smoke.numpy_params`, drawn with numpy so that the card's
machine draws them too) over the driver's `SyntheticSource` batches, at
llama3.2-3b's full width and vocabulary cut to 2 layers, in fp32 compute
on the CPU.  It prints both trajectories and fails unless they agree
within 1e-4 relative at every step; `chip_smoke.WITNESS_LOSSES` holds
the reference's, and phase 13 holds the card's steps to them.

Each package runs in a process of its own (about 12 GB each):

    PYTHONPATH=src python tests/train_full_width_witness.py

It takes about five minutes on 8 CPU cores.  Not collected by pytest.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))    # the repository's root, for chip_smoke

ARCH, LAYERS, B, S, STEPS, SEED = "llama3.2-3b", 2, 2, 512, 8, 0
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=10)


def _batches(vocab):
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    src = SyntheticSource(DataConfig(vocab, S, B, seed=SEED))
    return [src.batch(i) for i in range(STEPS)]


def _weights_path(tmp):
    return os.path.join(tmp, "weights.npz")


def run_port(tmp) -> list[float]:
    import torch
    from chip_smoke import numpy_params
    from repro_torch import configs, tree
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(
        configs.get(ARCH), n_layers=LAYERS, compute_dtype=torch.float32,
        kv_dtype=torch.float32, loss_chunk=0, remat="none")
    params = numpy_params(cfg, SEED)
    np.savez(_weights_path(tmp), **{"/".join(p): t.numpy() for p, t
                                     in tree.leaves_with_paths(params)})
    step = steps.build_train_step(cfg, adamw.AdamWConfig(**OPT))
    state = {"params": params, "opt": adamw.init(params)}
    losses = []
    for batch in _batches(cfg.vocab):
        state, m = step(state, {"tokens": torch.from_numpy(batch)})
        losses.append(float(m["loss"]))
    return losses


def run_reference(tmp) -> list[float]:
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch import steps
    from repro.optim import adamw
    cfg = dataclasses.replace(
        configs.get(ARCH), n_layers=LAYERS, compute_dtype=jnp.float32,
        kv_dtype=jnp.float32, loss_chunk=0, remat="none")
    params: dict = {}
    with np.load(_weights_path(tmp)) as data:
        for key in data.files:
            *head, last = key.split("/")
            node = params
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(data[key])
    step = jax.jit(steps.build_train_step(cfg, adamw.AdamWConfig(**OPT)))
    state = {"params": params, "opt": adamw.init(params)}
    losses = []
    for batch in _batches(cfg.vocab):
        state, m = step(state, {"tokens": jnp.asarray(batch)})
        losses.append(float(m["loss"]))
    return losses


def main() -> int:
    if len(sys.argv) == 3:          # one package, in a process of its own
        which, tmp = sys.argv[1:]
        losses = (run_port if which == "port" else run_reference)(tmp)
        print(json.dumps(losses))
        return 0
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("port", "reference"):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, __file__, which, tmp],
                                  capture_output=True, text=True, check=True)
            out[which] = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"{which:9s} {time.perf_counter() - t0:6.1f} s  "
                  f"{[f'{x:.6f}' for x in out[which]]}", flush=True)
    port, ref = np.array(out["port"]), np.array(out["reference"])
    rel = float(np.max(np.abs(port - ref) / np.abs(ref)))
    ln_v = float(np.log(128256))
    print(f"ln V {ln_v:.6f}; loss[7] - loss[0]: port "
          f"{port[-1] - port[0]:+.6f}, reference {ref[-1] - ref[0]:+.6f}; "
          f"max relative difference {rel:.3g}")
    print(json.dumps({"witness": {"arch": ARCH, "n_layers": LAYERS,
                                  "batch": B, "seq": S, **OPT,
                                  "port": out["port"],
                                  "reference": out["reference"],
                                  "max_rel": rel}}))
    return 0 if rel <= 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
