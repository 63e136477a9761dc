"""End-to-end driver: FOS multi-tenant acceleration over a fabric.

The paper's core scenario (section 5.5.2): mutually-unaware tenants submit
batched acceleration requests for *different* accelerators — an LM forward
(the "C accelerator"), mandelbrot (compute-bound) and sobel (memory-bound)
— and the resource-elastic policy time/space-multiplexes them over the
fabric's shells, replicating and reusing modules as load allows.

This is the Fabric-API port: shells are registered descriptors, the
fabric (a list of shell names) is itself a registered descriptor
(`fabrics.json`), and the daemon executes over all shells with
locality-aware placement and cross-shell work stealing — alice pins her
batch work to one shell with `affinity=`, and when the other shell goes
idle it steals her queued chunks.

Checkpointed preemption (`PolicyConfig.ckpt`): after the steady-state
tenants are admitted, dave fires a high-priority interactive *burst*
that evicts mid-flight batch chunks.  With checkpointing on, each
victim's progress is saved (priced by the cost model) instead of
discarded, and the chunk resumes at its remaining fraction — the
`ckpt` stats line shows the saves/restores/migrations the burst caused.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \
        [--device cpu]

On one GPU (or the CPU) the fabric is one shell (pure
time-multiplexing); with two or more GPUs it is two shells, with
spatial multiplexing and stealing.  On the card carol's `lm-forward`
runs the flash-attention kernel.  The trace goes to `trace.json` in the
working directory.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import Daemon, FabricDescriptor, ImplAlt, \
    ModuleDescriptor, PolicyConfig, QoSContract, Shell, \
    default_registry, uniform_shell
from repro_torch.models.api import resolve_device
from repro_torch.obs import FlightRecorder, export_chrome_trace


def build_shells(reg, device):
    """Split the devices into a two-shell fabric when there are two or
    more GPUs; the degenerate one-shell fabric on one GPU or the CPU."""
    if device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    n_dev = len(devs)
    if n_dev >= 2:
        half = n_dev // 2
        spec_a = uniform_shell("shellA", (1, half), half)
        spec_b = uniform_shell("shellB", (1, n_dev - half), n_dev - half)
        shells = {"shellA": Shell(spec_a, devs[:half]),
                  "shellB": Shell(spec_b, devs[half:])}
    else:
        spec_a = uniform_shell("shellA", (1, 1), 1)
        shells = {"shellA": Shell(spec_a, devs)}
    for sh in shells.values():
        reg.register_shell(sh.spec)
    reg.register_fabric(FabricDescriptor("example", tuple(shells)))
    return shells


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) \
        else np.asarray(x).shape


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    reg = default_registry()
    shells = build_shells(reg, device)
    # preemptive priority policy with checkpointing: carol's LM forward
    # is latency-sensitive (priority 3 + deadline); alice/bob run as
    # best-effort batch work whose chunks may be evicted — keeping their
    # progress — requeued, resumed, or stolen by an idle shell; the
    # flight recorder traces every event and samples the gauges every
    # 100 ms over the live daemon — the whole serving session below
    # lands in `daemon.metrics["obs"]` and a Perfetto-openable trace
    recorder = FlightRecorder(trace=True, sample_every_ms=100.0)
    daemon = Daemon(shells, reg,
                    PolicyConfig(preemptive=True, ckpt=True),
                    obs=recorder)
    fab = reg.fabric("example")
    print(f"fabric: {fab.name} -> "
          f"{[(n, len(s.slots)) for n, s in shells.items()]}; "
          f"modules: {sorted(reg.modules)}")

    rng = np.random.default_rng(0)
    re = rng.uniform(-2, 1, (256, 256)).astype(np.float32)
    im = rng.uniform(-1.5, 1.5, (256, 256)).astype(np.float32)
    img = rng.random((1024, 1024)).astype(np.float32)
    toks = rng.integers(0, 256, (8, 64)).astype(np.int32)

    first_shell = next(iter(shells))
    t0 = time.perf_counter()
    handles = {
        # alice pins her batch to one shell; the idle shell steals it
        "alice/mandelbrot": daemon.submit("alice", "mandelbrot",
                                          [(re, im)] * 4,
                                          affinity=first_shell),
        "bob/sobel": daemon.submit("bob", "sobel", [(img,)] * 4),
        "carol/lm-forward": daemon.submit("carol", "lm-forward",
                                          [(toks,)] * 2, priority=3,
                                          deadline_ms=5000.0),
    }
    # dave's interactive burst lands while the batch tenants are
    # mid-flight: high priority evicts resident chunks, whose progress
    # the checkpoint subsystem saves and later resumes
    time.sleep(0.2)
    frame = rng.random((1024, 1024)).astype(np.float32)
    for i in range(3):
        handles[f"dave/burst{i}"] = daemon.submit(
            "dave", "sobel", [(frame,)], priority=5, deadline_ms=2000.0)
    outputs = {}
    for name, h in handles.items():
        outs = h.future.result(timeout=600)
        outputs[name] = outs
        dt = time.perf_counter() - t0
        tag = f" (priority={h.priority})" if h.priority else ""
        print(f"  {name}: {len(outs)} chunks done at t={dt:.2f}s "
              f"(out[0] shape {_shape(outs[0])}){tag}")
    s = daemon.stats
    f = daemon.fabric.stats
    print(f"stats: chunks={s['chunks']} reconfigurations="
          f"{s['reconfigurations']} reuses={s['reuses']} "
          f"preemptions={s['preemptions']} "
          f"steals={f['steals']} stolen_chunks={f['stolen_chunks']} "
          f"local_dispatch={f['local_dispatch']} "
          f"scheduler={s['sched_ns'] / max(s['sched_calls'], 1) / 1e3:.0f}"
          f"us/event")
    c = daemon.ckpt_stats
    print(f"ckpt : saves={c.get('saves', 0)} "
          f"restores={c.get('restores', 0)} "
          f"migrations={c.get('migrations', 0)} "
          f"dropped={c.get('dropped', 0)}")

    # erin arrives late with a *QoS contract*: 20 req/s at a 35 ms p95
    # deadline, with "sobel-lite" (the same kernel declared at a cheaper
    # estimate) as her degraded tier.  Even on the now-drained fabric the
    # full sobel estimate is predicted infeasible at that deadline, so
    # the admission controller transparently DEGRADEs her submit — the
    # verdict and the per-tenant attainment ledger are printed below.
    reg.register_module(ModuleDescriptor(
        name="sobel-lite", entrypoint="repro_torch.core.zoo:build_sobel",
        impls=(ImplAlt("x1", 1, 2.0),), kind="fn"))
    daemon.register_contract(QoSContract(
        "erin", rate_per_s=20.0, deadline_ms=35.0,
        degraded="sobel-lite"))
    h_erin = daemon.submit("erin", "sobel", [(img,)], priority=4)
    v = daemon.fabric.jobs[h_erin.rid].verdict
    print(f"erin/sobel admission: {v.action}"
          + (f" -> {v.degraded_to!r} ({v.reason})"
             if v.action == "DEGRADE" else ""))
    h_erin.future.result(timeout=600)
    e = daemon.slo_stats.get("erin", {})
    att = e.get("attainment")
    print(f"slo  : erin submitted={e.get('submitted', 0)} "
          f"admitted={e.get('admitted', 0)} "
          f"degraded={e.get('degraded', 0)} "
          f"rejected={e.get('rejected', 0)} attainment="
          f"{att if att is None else format(att, '.2f')}")

    # the flight recorder saw the whole session: counters snapshot +
    # a chrome://tracing / Perfetto trace of every chunk span
    obs = daemon.metrics["obs"]
    oc = obs["counters"]
    print(f"obs  : submitted={oc['submitted']} "
          f"(admitted={oc['admitted']} degraded={oc['degraded']} "
          f"rejected={oc['rejected']}) "
          f"chunks={oc['chunks_started']}/{oc['chunks_completed']}"
          f"/{oc['chunks_preempted']} (start/done/evict) "
          f"steals={oc['steal_hits']}/{oc['steal_probes']} "
          f"samples={len(obs.get('samples', []))}")
    print("svc  : " + " ".join(
        f"{t}={ms:.0f}slot-ms"
        for t, ms in sorted(obs["tenant_service_ms"].items())))
    export_chrome_trace(recorder.tracer, "trace.json")
    print(f"trace: {len(recorder.tracer.events)} events -> trace.json "
          f"(open at https://ui.perfetto.dev)")
    daemon.shutdown()
    return {"outputs": outputs, "stats": dict(s), "obs": oc}


if __name__ == "__main__":
    main()
