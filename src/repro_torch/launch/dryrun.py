"""Dry run: each (arch x shape cell x mesh) step traced on fake ranks, with
per-rank FLOPs, bytes, collective bytes and memory, and the H100 roofline
terms.

The counterpart of `repro/launch/dryrun.py`, which lowers and compiles each
cell's jitted step on 512 host devices and reads XLA's cost and memory
analyses.  Here each cell's step (`steps.step_for_cell`) runs once as rank
0 of a `fake` process group of 256 ranks ((16, 16) "single") or 512
((2, 16, 16) "multi"), on FakeTensors (shapes, no storage), under
`op_analysis.OpRecorder`.  It computes nothing and touches no CUDA: the
counts are the plain route's (`attn_impl="xla"`) as the reference's are
XLA's, and `roofline_model.scores_traffic_bytes` takes out the score
tensors the port's kernels never write.  Run it as

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
        --shape all --mesh single

which writes one JSON per cell under --out (`build/dryrun/` by default,
which .gitignore lists).  Importing this module sets nothing and joins no
process group; `run_cell` joins a fake one and destroys it on the way out.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs, tree as tree_mod
from repro_torch.configs.common import apply_cell_policy
from repro_torch.launch import mesh as mesh_mod, roofline_model, steps
from repro_torch.models import layers, stack
from repro_torch.models.api import SHAPE_CELLS
from repro_torch.sharding import op_analysis, partition

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

FULL_ATTENTION_SKIP = "SKIP(full-attention): long_500k requires " \
    "sub-quadratic attention (see DESIGN.md)"


def cell_applicable(cfg, cell) -> bool:
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


def scale_groups(cfg, groups: int):
    """Config with `groups` layer-groups, for the g=1/g=2 traces of the
    cost extrapolation (the reference's HLO counts a while-loop body once;
    eager dispatch counts every group, so here the slope is exact and the
    extrapolation equals the full trace)."""
    _, plan = cfg.layer_plan()
    period = len(plan)
    upd = dict(n_layers=groups * period, scan_layers=False, loss_chunk=0,
               attn_unroll=True)
    if cfg.family == "encdec":
        upd["n_enc_layers"] = groups
    return dataclasses.replace(cfg, **upd)


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a `fake` process group of `world_size`
    ranks: collectives return at once and move nothing.  The group is
    destroyed on exit, so a later `mesh.init_distributed` in the process
    joins a real one, and `sys.excepthook` (which `init_process_group`
    wraps to prefix the rank) is put back."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry run needs its own fake one")
    hook = sys.excepthook
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def _map(fn, tree, *rest):
    """fn over the leaves of nested dicts and tuples (`rest` matched)."""
    if isinstance(tree, tuple):
        return tuple(_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return tree_mod.tree_map(fn, tree, *rest)


@contextlib.contextmanager
def fake_tensors():
    """FakeTensorMode for the traced program (shapes, no storage: a
    factory call under a CPU mesh makes a FakeTensor too), with a second
    fake mode in a `TracingContext` for DTensor's sharding propagation,
    which runs each DTensor op again on global shapes under the fake mode
    it detects: there it is the second one, so `OpRecorder` (which records
    the ops of the mode active on its entry) leaves those ops out."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    with tracing(TracingContext(FakeTensorMode())), FakeTensorMode():
        yield


def _fake(x: torch.Tensor) -> torch.Tensor:
    """A `meta` leaf as a FakeTensor on the CPU (under `fake_tensors`)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype)


def trace_cell(cfg, cell, mesh, rules, *, verbose=True):
    """Runs the cell's step once, as rank 0 of `mesh` runs it, on
    FakeTensors (`fake_tensors`) under an `OpRecorder`: each argument is
    cut to the rank's shard by `steps.cell_placements`; without a mesh the
    unsharded step runs on whole arguments.  A decode step writes the
    cache's last slot.  Returns (records, info dict: "trace_s", "memory",
    "cost")."""
    step = steps.step_for_cell(cfg, cell, mesh, rules)
    in_pl = (None if mesh is None
             else steps.cell_placements(cfg, cell, mesh, rules)[0])
    with fake_tensors():
        abstract = steps.abstract_inputs(cfg, cell)
        if mesh is None:
            args = _map(_fake, abstract)
        else:
            args = _map(lambda x, pl: partition.distribute(_fake(x), mesh,
                                                           pl),
                        abstract, in_pl)
        if cell.kind == "decode":     # the port's decode takes an int
            args = args[:3] + (cell.seq_len - 1,)
        rec = op_analysis.OpRecorder()
        rec.mark_arguments(op_analysis.local_tensors(args))
        t0 = time.perf_counter()
        with rec:
            out = step(*args)
        info = {"trace_s": time.perf_counter() - t0,
                "memory": op_analysis.memory_stats_dict(rec, args, out),
                "cost": op_analysis.cost_analysis_dict(rec.records)}
    if verbose:
        mem = info["memory"]
        print(f"    memory: args={mem['argument_size_in_bytes']:.4g} "
              f"temp={mem['temp_size_in_bytes']:.4g} "
              f"alias={mem['alias_size_in_bytes']:.4g}")
        ca = info["cost"]
        print(f"    cost: flops={ca['flops']:.4g} "
              f"bytes={ca['bytes accessed']:.4g} "
              f"({len(rec.records)} ops, {info['trace_s']:.1f} s)")
    return rec.records, info


def _sample(records) -> dict:
    return {"cost": op_analysis.cost_analysis_dict(records),
            "coll": op_analysis.collective_bytes(records),
            "hbm_model": op_analysis.hbm_model_bytes(records),
            "by_op": op_analysis.bytes_by_op(records)}


def attn_split(cfg, mesh, rules) -> dict | None:
    """The attention heads rank 0 computes with under `rules`
    (`layers.head_split` over the "model" ranks): {"q_heads", "kv_heads",
    "ranks"}, or {"whole": True} where the layer computes every head on
    each rank; None without attention."""
    if not cfg.n_heads:
        return None
    with partition.use_rules(rules):
        par = stack.parallel(cfg, mesh, rules.batch_axes)
    tp = par.tp.get("attn", ())
    if not tp:
        return {"whole": True}
    n = partition.axis_size(mesh, tp)
    q0, q1, k0, k1 = layers.head_split(cfg.n_heads, cfg.n_kv_heads, n)[0]
    return {"q_heads": q1 - q0, "kv_heads": k1 - k0, "ranks": n}


def run_cell(arch: str, cell_name: str, *, multi_pod: bool,
             cost_extrapolate: bool = True, rule_overrides=None,
             tag: str = "", cfg_overrides: dict | None = None) -> dict:
    """One cell's dry run on 256 (or, `multi_pod`, 512) fake ranks."""
    cell = SHAPE_CELLS[cell_name]
    base_cfg = configs.get(arch)
    if not cell_applicable(base_cfg, cell):
        return {"arch": arch, "cell": cell_name,
                "mesh": "multi" if multi_pod else "single",
                "skipped": FULL_ATTENTION_SKIP}
    cfg = apply_cell_policy(base_cfg, cell)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **{k: v for k, v in
                                          cfg_overrides.items()
                                          if k != "train_rules"})
    chips = 512 if multi_pod else 256
    kind = "train" if cell.kind == "train" else "serve"
    if kind == "train" and (cfg_overrides or {}).get(
            "train_rules") == "train_fsdp":
        kind = "train_fsdp"
    overrides = dict(rule_overrides or {})
    if cell.kind != "train" and cell.global_batch < 16:
        # batch too small to shard over "data" (e.g. long_500k b=1):
        # replicate batch, spread the cache sequence over data AND model
        overrides.setdefault("batch", None)
        overrides.setdefault(
            "seq_kv", ("pod", "data", "model") if multi_pod
            else ("data", "model"))
    rules = partition.make_rules(kind, multi_pod=multi_pod,
                                 overrides=overrides)

    result = {"arch": arch, "cell": cell_name,
              "mesh": "multi" if multi_pod else "single", "chips": chips,
              "tag": tag}
    print(f"[dryrun] {arch} x {cell_name} x "
          f"{'multi' if multi_pod else 'single'}-pod ({chips} fake ranks)")
    with fake_world(chips):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        result["attn_split"] = attn_split(cfg, mesh, rules)
        records, info = trace_cell(cfg, cell, mesh, rules)
        # every op of every group is dispatched, so the full trace's
        # collectives are the step's own (the reference's HLO of a scan
        # counts one group's)
        info["coll"] = op_analysis.collective_bytes(records)
        result["full"] = info
        del records

        if cost_extrapolate:
            # two small traces, g=1 and g=2 layer groups, extrapolated to
            # the config's depth as the reference does; every group
            # dispatches the same ops, so the slope is exact
            n_groups, _ = cfg.layer_plan()
            samples = {}
            for g in (1, 2):
                records, _ = trace_cell(scale_groups(cfg, g), cell, mesh,
                                        rules, verbose=False)
                samples[g] = _sample(records)
                del records
    if cost_extrapolate:
        f1 = samples[1]["cost"].get("flops", 0.0)
        f2 = samples[2]["cost"].get("flops", 0.0)
        b1 = samples[1]["hbm_model"]
        b2 = samples[2]["hbm_model"]
        raw_b1 = samples[1]["cost"].get("bytes accessed", 0.0)
        raw_b2 = samples[2]["cost"].get("bytes accessed", 0.0)
        c1 = samples[1]["coll"]["total"]
        c2 = samples[2]["coll"]["total"]
        flops_dev = max(f1 + (f2 - f1) * (n_groups - 1), f1, f2)
        bytes_dev = max(b1 + (b2 - b1) * (n_groups - 1), b1, b2)
        raw_bytes_dev = max(raw_b1 + (raw_b2 - raw_b1) * (n_groups - 1),
                            raw_b1, raw_b2)
        coll_dev = max(c1 + (c2 - c1) * (n_groups - 1), c1, c2)
        result["extrapolated"] = {
            "n_groups": n_groups,
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "raw_bytes_per_device": raw_bytes_dev,
            "coll_bytes_per_device": coll_dev,
            "g1": samples[1], "g2": samples[2],
        }
        terms = roofline_model.terms_from_costs(
            flops_dev, bytes_dev, coll_dev, chips, cfg, cell)
        result["roofline"] = terms.to_dict()
        print(f"    roofline: compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"dominant={terms.dominant} "
              f"frac={terms.roofline_fraction:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost-extrapolation traces")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--kv-f8", action="store_true",
                    help="store KV caches in float8_e4m3 (beyond-paper)")
    ap.add_argument("--remat", default=None, choices=["none", "full",
                                                      "dots"])
    ap.add_argument("--train-rules", default="train",
                    choices=["train", "train_fsdp"])
    args = ap.parse_args(argv)
    cfg_overrides: dict = {}
    if args.kv_f8:
        cfg_overrides["kv_dtype"] = torch.float8_e4m3fn
    if args.remat:
        cfg_overrides["remat"] = args.remat
    if args.train_rules != "train":
        cfg_overrides["train_rules"] = args.train_rules

    archs = configs.ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = (list(SHAPE_CELLS) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    outdir = Path(args.out)
    failures = []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                mesh_name = "multi" if multi_pod else "single"
                fname = (f"{shape}.json" if args.tag == "baseline"
                         else f"{shape}__{args.tag}.json")
                path = outdir / mesh_name / arch / fname
                path.parent.mkdir(parents=True, exist_ok=True)
                try:
                    res = run_cell(
                        arch, shape, multi_pod=multi_pod,
                        cost_extrapolate=(not args.no_cost and not multi_pod),
                        tag=args.tag, cfg_overrides=cfg_overrides or None)
                except Exception as e:  # noqa: BLE001 - record and continue
                    traceback.print_exc()
                    res = {"arch": arch, "cell": shape, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append((arch, shape, mesh_name))
                res["tag"] = args.tag
                path.write_text(json.dumps(res, indent=2))
    if failures:
        print(f"FAILURES ({len(failures)}): {failures}")
        raise SystemExit(1)
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()
