"""Serving: prefill + batched decode, optionally via the FOS daemon.

Mirrors `repro/launch/serve.py`.  Single-tenant mode runs prefill and
greedy decode directly on one device; multi-tenant mode (`--daemon`)
routes batched requests through the resource-elastic daemon with
per-tenant priorities and deadlines: an interactive tenant submits short
high-priority requests with an SLO deadline while batch tenants keep the
shell saturated, and the preemptive policy evicts batch chunks to hit the
SLO.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --daemon [--contract]
        [--trace-out trace.json]
    torchrun --nproc-per-node=<gpus> -m repro_torch.launch.serve

Launched by torchrun over more than one rank, `serve` runs SPMD over
every rank of the world: a (1, n) ("data", "model") mesh under the
"serve" rules, the params and the prompt as DTensors at their placements
(each rank holds its tensor-parallel share of the weights), the KV cache
sequence-sharded over "model" (`steps.build_prefill_step` /
`build_decode_step`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod, steps
from repro_torch.models import api, io, stack
from repro_torch.models.api import ShapeCell
from repro_torch.sharding import partition


@dataclasses.dataclass
class ServeRun:
    arch: str = "llama3.2-3b"
    reduced: bool = True
    batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 32
    seed: int = 0
    device: str = "cuda"
    attn_impl: str = "pallas"       # "pallas": Hopper kernels | "xla": plain


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompt: torch.Tensor, max_new_tokens: int,
             extra: dict | None = None, mesh=None, rules=None):
    """Prefill `prompt` [B, S], then decode greedily.  `extra` holds the
    prefill's other inputs, as `io.make_batch` makes them: whisper's
    "frames", phi-3-vision's "patches".  With a mesh and rules, `params`,
    `prompt` and `extra` are DTensors at their placements and the steps
    run sharded; the tokens fed back are put over the batch axes.

    Returns (tokens [B, T], logits [B, T, V], prefill_s, decode_s) with
    T = max_new_tokens, whole on every rank: token t is the argmax of
    logits t, which come from the prefill (t = 0) and from decode steps
    1..T-1.  Times are wall-clock seconds, each ended by a device
    synchronise.
    """
    device = partition.local(prompt).device
    b, s = prompt.shape
    if mesh is None:
        prefill = stack.build_prefill_fn(cfg, max_len=s + max_new_tokens)
        decode = stack.build_decode_fn(cfg)

        def put(t):
            return t
    else:
        cell = ShapeCell("serve", s + max_new_tokens, b, "prefill")
        prefill = steps.build_prefill_step(cfg, cell, mesh, rules)
        decode = steps.build_decode_step(cfg, mesh, rules)

        def put(t):
            return partition.distribute(t, mesh, partition.to_placements(
                ("batch", None), rules, mesh))
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        cache, logits = prefill(params, {**(extra or {}), "tokens": prompt})
        logits = partition.full(logits)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        out_tokens, out_logits = [tok[:, 0]], [logits]
        t0 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            cache, nxt, logits = decode(params, cache, put(tok), s + i)
            nxt, logits = partition.full(nxt), partition.full(logits)
            tok = nxt[:, None]
            out_tokens.append(nxt)
            out_logits.append(logits)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return (torch.stack(out_tokens, dim=1), torch.stack(out_logits, dim=1),
            t_prefill, t_decode)


def serve_inputs(run: ServeRun, device):
    """(cfg, params, prompt [B, S], extra) of a served run on `device`:
    params from `api.init_params` seeded with `run.seed`, the prompt (and
    whisper's stub frames or phi-3-vision's stub patches, `extra`) from
    `io.make_batch` seeded with `run.seed + 1`.  phi-3-vision's prompt
    must be at least n_patches long, as the reference's splice assumes
    (ValueError)."""
    cfg = configs.get(run.arch, reduced=run.reduced)
    if run.prompt_len < cfg.n_patches:
        raise ValueError(f"{run.arch}: the prompt ({run.prompt_len} tokens) "
                         f"must hold the {cfg.n_patches} image patches")
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              kv_dtype=torch.float32,
                              attn_impl=run.attn_impl, ssd_impl="pallas")
    if cfg.moe is not None:
        # MoE layers follow the kernel knob: the card path gathers tokens
        # to experts ("ep"), the plain path is the one-hot oracle
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep" if run.attn_impl == "pallas" else "dense"))
    gen = torch.Generator(device=device)
    params = api.init_params(cfg, gen.manual_seed(run.seed))
    cell = io.smoke_cell("prefill", b=run.batch, s=run.prompt_len)
    batch = io.make_batch(cfg, cell, gen.manual_seed(run.seed + 1))
    prompt = batch.pop("tokens")
    return cfg, params, prompt, batch


def shard_inputs(cfg, params, prompt, extra, mesh, rules):
    """The params, prompt and extra inputs (whole and equal on every rank)
    as DTensors at the rules' placements: each rank keeps its slices."""
    def put(tree):
        axes = {k: ("batch",) + (None,) * (v.dim() - 1)
                for k, v in tree.items()}
        return partition.distribute_tree(tree, axes, mesh, rules)
    return (partition.distribute_tree(params, api.param_specs(cfg), mesh,
                                      rules),
            put({"tokens": prompt})["tokens"], put(extra))


def serve(run: ServeRun, log=print) -> dict:
    """Prefill a random prompt (`serve_inputs`), then decode greedily.

    Returns prefill_s, decode_tok_per_s and tokens [B, max_new_tokens]
    (numpy) as the reference does, plus the prompt, its other inputs
    (`extra`: {} or the stub frames or patches) and the logits the tokens
    were taken from (prefill's, then each decode step's), stacked
    [B, max_new_tokens, V] on the device.  Launched over more than one
    rank it serves over all of them (see the module docstring); the
    params and the prompt are drawn whole on each rank from the same
    seeds, and each rank keeps its slices.
    """
    sharded = mesh_mod.launched_world() > 1
    if sharded:
        device = mesh_mod.init_distributed(run.device)
    else:
        device = api.resolve_device(run.device)
    cfg, params, prompt, batch = serve_inputs(run, device)
    mesh = rules = None
    args = (params, prompt, batch)
    if sharded:
        mesh = mesh_mod.make_mesh((1, torch.distributed.get_world_size()),
                                  ("data", "model"))
        rules = partition.make_rules("serve")
        args = shard_inputs(cfg, params, prompt, batch, mesh, rules)
    tokens, logits, t_prefill, t_decode = generate(
        cfg, *args[:2], run.max_new_tokens, extra=args[2], mesh=mesh,
        rules=rules)
    toks_per_s = (run.batch * (run.max_new_tokens - 1)) / max(t_decode, 1e-9)
    log(f"[serve] {run.arch} on {device} ({run.attn_impl}): prefill "
        f"{t_prefill * 1e3:.1f} ms, decode {toks_per_s:.1f} tok/s "
        f"(batch={run.batch})")
    return {"prefill_s": t_prefill, "decode_tok_per_s": toks_per_s,
            "tokens": tokens.cpu().numpy(), "prompt": prompt,
            "extra": batch, "logits": logits}


@dataclasses.dataclass
class DaemonServeRun:
    """Multi-tenant serving through the FOS daemon with SLO classes."""
    n_interactive: int = 6          # high-priority single-chunk requests
    n_batch: int = 2                # low-priority multi-chunk requests
    batch_chunks: int = 4
    priority_hi: int = 3
    deadline_ms: float = 2000.0     # interactive SLO (wall clock, live)
    preemptive: bool = True
    contract: bool = False          # register a QoSContract for "live"
    contract_rate_per_s: float = 50.0
    trace_out: str = ""             # write a Chrome trace here (Perfetto)
    seed: int = 0
    device: str = "cuda"


def serve_daemon(run: DaemonServeRun, log=print) -> dict:
    """Drive the resource-elastic daemon with two SLO classes.

    Batch tenants submit long mandelbrot requests at priority 0; an
    interactive tenant submits short sobel requests at `priority_hi` with a
    deadline.  Under the preemptive policy the daemon cancels and requeues
    batch chunks when the interactive class would otherwise queue behind
    them.  With `contract=True` the live tenant additionally registers a
    `QoSContract` (deadline = `deadline_ms`, degraded mode "sobel-lite"):
    submits are screened by the admission controller, and the result dict
    carries the live SLO attainment ledger.  The shell has one slot for
    each CUDA device (one slot on the CPU with `device="cpu"`).  Returns
    per-class latency stats and the daemon counters, plus the handles and
    the inputs, for a caller that checks the outputs.
    """
    from repro_torch.core import AdmissionRejected, Daemon, ImplAlt, \
        ModuleDescriptor, PolicyConfig, QoSContract, Shell, \
        default_registry, uniform_shell
    from repro_torch.core.daemon import _now_ms
    from repro_torch.core.simulator import p95

    device = api.resolve_device(run.device)
    if device.type == "cuda":
        n_dev, devices = torch.cuda.device_count(), None
    else:
        n_dev, devices = 1, [device]
    spec = uniform_shell(f"serve{n_dev}_s{n_dev}", (1, n_dev), n_dev)
    reg = default_registry()
    reg.register_shell(spec)
    recorder = None
    if run.trace_out:
        from repro_torch.obs import FlightRecorder
        # wall-clock sampling: one gauge row per 100 ms of serving
        recorder = FlightRecorder(sample_every_ms=100.0)
    daemon = Daemon(Shell(spec, devices), reg,
                    PolicyConfig(preemptive=run.preemptive), obs=recorder)
    contract = None
    if run.contract:
        # the degraded tier: same sobel kernel builder, declared at a
        # cheaper estimate so the controller can swap to it when the
        # full-rate contract stops being feasible
        reg.register_module(ModuleDescriptor(
            name="sobel-lite", entrypoint="repro_torch.core.zoo:build_sobel",
            impls=(ImplAlt("x1", 1, 2.0),), kind="fn"))
        contract = QoSContract("live", rate_per_s=run.contract_rate_per_s,
                               deadline_ms=run.deadline_ms,
                               degraded="sobel-lite")
        daemon.register_contract(contract)
    rng = np.random.default_rng(run.seed)
    re_t = rng.uniform(-2, 1, (256, 256)).astype(np.float32)
    im_t = rng.uniform(-1.5, 1.5, (256, 256)).astype(np.float32)
    img = rng.random((1024, 1024)).astype(np.float32)
    try:
        t0 = time.perf_counter()
        batch_handles = [
            daemon.submit(f"batch{i}", "mandelbrot",
                          [(re_t, im_t)] * run.batch_chunks, priority=0)
            for i in range(run.n_batch)]
        done_at: dict[int, float] = {}
        live_handles = []
        for _ in range(run.n_interactive):
            h = daemon.submit("live", "sobel", [(img,)],
                              priority=run.priority_hi,
                              deadline_ms=run.deadline_ms)
            # stamp completion when it happens; JobHandle.t_submit is on
            # the scheduler's millisecond clock, so stamp in ms too
            h.future.add_done_callback(
                lambda _, rid=h.rid: done_at.setdefault(rid, _now_ms()))
            live_handles.append(h)
        rejected = 0
        for h in live_handles + batch_handles:
            try:
                h.future.result(timeout=600)
            except AdmissionRejected:
                rejected += 1       # shed by the contract screen
        live_lat = [done_at[h.rid] - h.t_submit for h in live_handles
                    if h.future.exception() is None]
        wall = time.perf_counter() - t0
        live_p95 = p95(live_lat)
        misses = sum(1 for l in live_lat if l > run.deadline_ms)
        s = daemon.stats
        slo = daemon.slo_stats if run.contract else {}
        extra = ""
        if run.contract and "live" in slo:
            lv = slo["live"]
            att = lv["attainment"]
            extra = (f", contract: {lv['admitted']} admitted / "
                     f"{lv['degraded']} degraded / "
                     f"{lv['rejected']} rejected"
                     + (f", attainment {att:.2f}"
                        if att is not None else ""))
        log(f"[serve/daemon] {n_dev} slot(s), "
            f"{'preemptive' if run.preemptive else 'cooperative'}: "
            f"live p95 {live_p95:.0f} ms "
            f"({misses}/{len(live_lat)} SLO misses), "
            f"wall {wall:.2f}s, chunks={s['chunks']} "
            f"preemptions={s['preemptions']} "
            f"reconfigs={s['reconfigurations']} reuses={s['reuses']}"
            f"{extra}")
        result = {"live_p95_ms": live_p95, "slo_misses": misses,
                  "live_rejected": rejected, "wall_s": wall,
                  "stats": dict(s), "slo": slo, "metrics": daemon.metrics,
                  "handles": {"live": live_handles, "batch": batch_handles},
                  "inputs": {"mandelbrot": (re_t, im_t), "sobel": (img,)}}
        if recorder is not None:
            from repro_torch.obs import export_chrome_trace
            export_chrome_trace(recorder.tracer, run.trace_out)
            c = recorder.counts
            log(f"[serve/daemon] obs: {len(recorder.tracer.events)} "
                f"trace events -> {run.trace_out} (open in Perfetto); "
                f"chunks started={c['chunks_started']} "
                f"completed={c['chunks_completed']} "
                f"preempted={c['chunks_preempted']}")
        return result
    finally:
        daemon.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--daemon", action="store_true",
                    help="multi-tenant SLO serving through the FOS daemon")
    ap.add_argument("--priority-hi", type=int, default=3)
    ap.add_argument("--deadline-ms", type=float, default=2000.0)
    ap.add_argument("--no-preempt", action="store_true")
    ap.add_argument("--contract", action="store_true",
                    help="register a QoSContract for the live tenant "
                         "(admission screening + attainment ledger)")
    ap.add_argument("--contract-rate", type=float, default=50.0,
                    help="contract target arrival rate (jobs/s)")
    ap.add_argument("--trace-out", default="",
                    help="with --daemon: attach the flight recorder and "
                         "write a Chrome trace JSON here (open in "
                         "Perfetto)")
    args = ap.parse_args()
    if args.daemon:
        serve_daemon(DaemonServeRun(priority_hi=args.priority_hi,
                                    deadline_ms=args.deadline_ms,
                                    preemptive=not args.no_preempt,
                                    contract=args.contract,
                                    contract_rate_per_s=args.contract_rate,
                                    trace_out=args.trace_out,
                                    device=args.device))
        return
    serve(ServeRun(arch=args.arch, batch=args.batch,
                   prompt_len=args.prompt_len,
                   max_new_tokens=args.max_new_tokens, device=args.device))


if __name__ == "__main__":
    main()
