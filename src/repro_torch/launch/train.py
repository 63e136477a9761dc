"""End-to-end training driver.

Mirrors `repro/launch/train.py`: model zoo + AdamW + data pipeline + async
checkpointing + watchdog/fault-injection restarts + optional gradient
compression + FOS elastic re-partitioning (save -> rebuild the step for
the next layout -> restore -> continue), with the reference's control
flow and `history` keys.

It runs SPMD over every rank of the world (`TrainRun.device`, default
"cuda", one GPU a rank; "cpu" when asked for, gloo ranks), as the
reference runs over every device: the mesh is (n, 1) ("data", "model"),
the state is DTensors at the "train" rules' placements and each rank
takes its shard of the global batch.  Without torchrun the world is this
one process.  The elastic switch saves, returns, re-enters in phase 1,
whose rules flip `embed` from "data" to None, and restores the
checkpoint onto the new placements (the FOS replacement primitive).

    python -m repro_torch.launch.train [--device cpu] [--arch ...] [--full]
    torchrun --nproc-per-node=<gpus> -m repro_torch.launch.train ...
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.fault import FaultInjector, InjectedFault, StepTimeout, \
    Watchdog, run_with_restarts
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import mesh as mesh_mod, steps as steps_mod
from repro_torch.optim import adamw, grad_compress as gc
from repro_torch.sharding import partition


@dataclasses.dataclass
class TrainRun:
    arch: str = "llama3.2-3b"
    reduced: bool = True
    steps: int = 30
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 1e-3
    ckpt_dir: str | None = None
    ckpt_every: int = 10
    resume: bool = False
    grad_compress: bool = False
    fail_at_step: int | None = None
    elastic_switch_step: int | None = None   # re-partition mid-run
    watchdog_timeout_s: float = 300.0
    log_every: int = 5
    seed: int = 0
    device: str = "cuda"


def _mesh_and_rules(elastic_phase: int = 0):
    n = torch.distributed.get_world_size()
    mesh = mesh_mod.make_mesh((n, 1), ("data", "model"))
    # elastic phase 1 flips the FSDP rule: restoring across phases
    # exercises reshard-on-restore (the FOS replacement primitive)
    overrides = {"embed": None} if elastic_phase else None
    rules = partition.make_rules("train", overrides=overrides)
    return mesh, rules


def _build(cfg, run: TrainRun, mesh, rules):
    opt_cfg = adamw.AdamWConfig(lr=run.lr, warmup_steps=5,
                                total_steps=max(run.steps, 10))
    return steps_mod.build_train_step(cfg, opt_cfg, mesh, rules,
                                      grad_compress=run.grad_compress)


def _state_placements(cfg, run: TrainRun, mesh, rules):
    return partition.tree_placements(
        steps_mod.train_state_axis_specs(cfg, run.grad_compress), rules, mesh)


def _init_state(cfg, run: TrainRun, device, mesh, rules):
    gen = torch.Generator(device=device).manual_seed(run.seed)
    state = steps_mod.init_train_state(cfg, gen, device)
    if run.grad_compress:
        state["ef"] = gc.init_error_feedback(state["params"])
    return steps_mod.shard_train_state(state, cfg, mesh, rules)


def _like_state(cfg, run: TrainRun):
    """The train state's shapes and dtypes as `meta` tensors (nothing
    allocated): the target structure of a restore."""
    state = steps_mod.abstract_train_state(cfg)
    if run.grad_compress:
        state["ef"] = gc.init_error_feedback(state["params"])
    return state


def train(run: TrainRun, log=print) -> dict:
    device = mesh_mod.init_distributed(run.device)
    if torch.distributed.get_rank() != 0:
        log = lambda *_: None   # noqa: E731 - one rank speaks
    cfg = configs.get(run.arch, reduced=run.reduced)
    cfg = dataclasses.replace(cfg, loss_chunk=0, remat="none",
                              scan_layers=True)
    mgr = CheckpointManager(run.ckpt_dir) if run.ckpt_dir else None
    injector = FaultInjector(run.fail_at_step)
    history: dict = {"loss": [], "restarts": 0, "elastic_switches": 0,
                     "steps_per_sec": 0.0}

    def run_fn(start_step: int) -> int:
        phase = 1 if (run.elastic_switch_step is not None
                      and start_step >= run.elastic_switch_step) else 0
        return _run_phase(start_step, phase)

    def _run_phase(start_step: int, phase: int) -> int:
        mesh, rules = _mesh_and_rules(phase)
        step_fn = _build(cfg, run, mesh, rules)
        if mgr is not None and (run.resume or start_step > 0) \
                and mgr.latest_step() is not None:
            ck = mgr.latest_step()
            state = mgr.restore(ck, _like_state(cfg, run), device, mesh,
                                _state_placements(cfg, run, mesh, rules))
            start = ck
            log(f"[train] restored step {ck} (phase {phase})")
        else:
            state = _init_state(cfg, run, device, mesh, rules)
            start = 0
        batch_pl = partition.tree_placements({"tokens": ("batch", None)},
                                             rules, mesh)
        data = Pipeline(DataConfig(cfg.vocab, run.seq_len,
                                   run.global_batch, seed=run.seed),
                        start_step=start)
        wd = Watchdog(run.watchdog_timeout_s,
                      on_timeout=lambda: log("[train] WATCHDOG timeout"))
        wd.start()
        t0 = time.perf_counter()
        try:
            for step, batch in data:
                if step >= run.steps:
                    break
                if (run.elastic_switch_step is not None and phase == 0
                        and step >= run.elastic_switch_step):
                    if mgr is not None:
                        mgr.save(step, state, blocking=True)
                    history["elastic_switches"] += 1
                    log(f"[train] elastic re-partition at step {step}")
                    return step          # supervisor re-enters in phase 1
                injector.check(step)
                wd.beat()
                if wd.fired:
                    raise StepTimeout(f"straggler at step {step}")
                batch = {k: partition.distribute(
                    torch.from_numpy(v).to(device), mesh, batch_pl[k])
                         for k, v in batch.items()}
                state, metrics = step_fn(state, batch)
                if step % run.log_every == 0 or step == run.steps - 1:
                    loss = float(metrics["loss"])
                    history["loss"].append((step, loss))
                    log(f"[train] step {step} loss {loss:.4f} "
                        f"gnorm {float(metrics['grad_norm']):.3f}")
                if mgr is not None and step and step % run.ckpt_every == 0:
                    mgr.save(step, state)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            history["steps_per_sec"] = (run.steps - start) / max(dt, 1e-9)
            if mgr is not None:
                mgr.save(run.steps, state, blocking=True)
                mgr.wait()
            return run.steps
        except InjectedFault:
            if mgr is not None:
                mgr.wait()
            raise
        finally:
            wd.stop()
            data.close()

    def supervised(start: int) -> int:
        step = start
        while step < run.steps:
            step = run_fn(step)
        return step

    final, restarts = run_with_restarts(supervised, log=log)
    history["restarts"] = restarts
    history["final_step"] = final
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full assigned config (not reduced)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--elastic-switch-step", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    run = TrainRun(arch=args.arch, reduced=not args.full, steps=args.steps,
                   global_batch=args.batch, seq_len=args.seq, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, resume=args.resume,
                   grad_compress=args.grad_compress,
                   fail_at_step=args.fail_at_step,
                   elastic_switch_step=args.elastic_switch_step,
                   device=args.device)
    hist = train(run)
    if torch.distributed.get_rank() != 0:
        return
    print(f"[train] done: {hist['final_step']} steps, "
          f"{hist['steps_per_sec']:.2f} steps/s, "
          f"restarts={hist['restarts']}, "
          f"final loss={hist['loss'][-1][1]:.4f}")


if __name__ == "__main__":
    main()
