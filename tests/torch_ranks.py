"""Spawned gloo ranks for the port's multi-rank tests on the CPU.

    python tests/torch_ranks.py <job> <world> <workdir>

starts `world` processes, joins them in one gloo process group through a
`FileStore` in `workdir` (no port), and runs `JOBS[job](rank, world,
workdir)` on each; each rank's result is `torch.save`d to
`workdir/rank<r>.pt`.  `run(job, world, workdir)` does this in a
subprocess with a timeout of its own and returns the results, rank by
rank.  The jobs read their inputs (weights, tokens, the reference's shard
indices) from files the test wrote into `workdir`; they import torch and
the port only, never jax.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600


def run(job: str, world: int, workdir: Path) -> list:
    """Every rank's result of `job` on `world` spawned gloo ranks."""
    import torch
    store = workdir / f"store_{job}"       # a FileStore serves one group
    if store.exists():
        store.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(Path(__file__)), job, str(world), str(workdir)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _main(rank: int, job: str, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(1)
    mesh_mod.init_distributed("cpu",
                              store_path=str(Path(workdir) / f"store_{job}"),
                              rank=rank, world_size=world)
    try:
        result = JOBS[job](rank, world, Path(workdir))
        torch.save(result, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# shared helpers of the jobs
# ---------------------------------------------------------------------------


def _cfg(arch: str, **kw):
    """The reduced config in fp32 (params, compute, cache), as the
    reference's distribution test takes it; MoE on the expert-parallel
    route with capacity 8 (no token drops)."""
    import torch
    from repro_torch import configs
    cfg = configs.get(arch, reduced=True)
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              kv_dtype=torch.float32, **kw)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep", capacity_factor=8.0))
    return cfg


def _load_tree(path: Path) -> dict:
    """A nested dict of tensors from an .npz written by `save_tree`."""
    import torch
    from repro_torch.models import api
    with np.load(path) as data:
        return api.unflatten((k, torch.from_numpy(data[k].copy()))
                             for k in data.files)


def save_tree(path: Path, tree: dict) -> None:
    """A nested dict of numpy arrays as an .npz keyed by '/' paths."""
    from repro_torch.models import api
    np.savez(path, **{k: np.asarray(v) for k, v in api.flatten(tree)})


def _full(x):
    from repro_torch.sharding import partition
    return partition.full(x).detach().clone()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def job_placements(rank, world, workdir):
    """Every arch's params under each rule set and mesh, filled with their
    flat index, distributed: the slices this rank holds, as
    [(start, stop) per dim], checked against the content."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api
    from repro_torch.sharding import partition
    cases = json.loads((workdir / "cases.json").read_text())
    meshes = {name: mesh_mod.make_mesh(tuple(shape), tuple(axes))
              for name, (shape, axes) in cases["meshes"].items()}
    out = {}
    for arch in cases["archs"]:
        cfg = configs.get(arch, reduced=True)
        table = api.flatten(api.param_table(cfg))
        axes = dict(api.flatten(api.param_specs(cfg)))
        for mname, mesh in meshes.items():
            multi = "pod" in mesh.mesh_dim_names
            coord = tuple(mesh.get_coordinate())
            for kind in cases["kinds"]:
                rules = partition.make_rules(kind, multi_pod=multi)
                for path, spec in table:
                    n = int(np.prod(spec.shape))
                    x = torch.arange(n, dtype=torch.float64).reshape(
                        spec.shape)
                    pl = partition.to_placements(axes[path], rules, mesh)
                    loc = partition.distribute(x, mesh, pl).to_local()
                    lo = np.unravel_index(int(loc.flatten()[0]), spec.shape) \
                        if loc.numel() else (0,) * len(spec.shape)
                    sl = [(int(a), int(a) + int(m))
                          for a, m in zip(lo, loc.shape)]
                    index = tuple(slice(a, b) for a, b in sl)
                    ok = bool(torch.equal(loc, x[index]))
                    out[f"{arch}|{kind}|{mname}|{path}"] = (coord, sl, ok)
    return out


def job_models(rank, world, workdir):
    """The six archs' loss ("train" rules), prefill and decode logits
    ("serve" rules) on a (2, 4) ("data", "model") mesh; decode at a cache
    length the shards do not divide (the pad path) and at one they divide
    (the update-inside path), and on the kernel route llama's decode (its
    attention computed whole) and phi-3-vision's (heads split over
    "model")."""
    import torch
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models import api, convert, stack
    from repro_torch.models.api import ShapeCell
    from repro_torch.sharding import partition
    cases = json.loads((workdir / "models.json").read_text())
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"))
    train_rules = partition.make_rules("train")
    serve_rules = partition.make_rules("serve")
    out = {}
    with torch.inference_mode():
        for arch in cases["archs"]:
            cfg = _cfg(arch)
            params = convert.params_from_numpy(
                _load_tree(workdir / f"{arch}_params.npz"), cfg, "cpu")
            io_np = _load_tree(workdir / f"{arch}_io.npz")
            batch = {k[2:]: v for k, v in io_np.items() if k[:2] == "t_"}
            pbatch = {k[2:]: v for k, v in io_np.items() if k[:2] == "p_"}
            tok = io_np["tok"]
            batch_axes = train_rules.batch_axes

            def put(tree, rules):
                axes = {k: ("batch",) + (None,) * (v.dim() - 1)
                        for k, v in tree.items()}
                return partition.distribute_tree(tree, axes, mesh, rules)

            p_train = partition.distribute_tree(
                params, api.param_specs(cfg), mesh, train_rules)
            with partition.use_rules(train_rules):
                loss = stack.build_loss_fn(cfg, mesh, batch_axes)(
                    p_train, put(batch, train_rules))
            out[f"{arch}/train_loss"] = float(loss)
            p_serve = partition.distribute_tree(
                params, api.param_specs(cfg), mesh, serve_rules)
            s = pbatch["tokens"].shape[1]
            variants = [("", s + 2, cfg)]          # 18 rows over 4 shards
            variants.append(("_even", s + 4, cfg))  # 20: update inside
            if cfg.family in ("dense", "vlm"):    # tensor-parallel: vlm
                variants.append(("_pallas", s + 2, dataclasses.replace(
                    cfg, attn_impl="pallas")))
            for tag, max_len, c in variants:
                cell = ShapeCell("p", max_len, pbatch["tokens"].shape[0],
                                 "prefill")
                prefill = steps.build_prefill_step(c, cell, mesh, serve_rules)
                decode = steps.build_decode_step(c, mesh, serve_rules)
                cache, logits = prefill(p_serve, put(pbatch, serve_rules))
                tok_d = put({"t": tok}, serve_rules)["t"]
                _, nxt, dlogits = decode(p_serve, cache, tok_d, s)
                out[f"{arch}/prefill_logits{tag}"] = _full(logits)
                out[f"{arch}/decode_logits{tag}"] = _full(dlogits)
                out[f"{arch}/next_tok{tag}"] = _full(nxt)
    return out


def job_train_tp(rank, world, workdir):
    """The non-MoE archs on the (2, 4) ("data", "model") mesh: one train
    step under "train" (FSDP over "data", tensor parallelism over "model")
    and under "train_fsdp" (FSDP over both, the batch tiled to 8 rows):
    the loss, the grad norm and the gradient the optimizer takes, whole;
    and what a rank holds of the first layer group's params and computes
    with under "train" and "serve" (shapes), with each layer kind's
    tensor-parallel axes."""
    import torch
    from repro_torch import tree as tree_mod
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models import api, convert, stack
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    cases = json.loads((workdir / "train_tp.json").read_text())
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(**cases["opt"])
    out = {}
    real_update = adamw.update
    for arch in cases["archs"]:
        cfg = _cfg(arch)
        params = convert.params_from_numpy(
            _load_tree(workdir / f"{arch}_params.npz"), cfg, "cpu")
        io_np = _load_tree(workdir / f"{arch}_io.npz")
        batch = {k[2:]: v for k, v in io_np.items() if k[:2] == "t_"}
        for kind in ("train", "train_fsdp", "serve"):
            rules = partition.make_rules(kind)
            shapes = {}
            with partition.use_rules(rules):
                par = stack.parallel(cfg, mesh, rules.batch_axes)
                held = partition.distribute_tree(params, api.param_specs(cfg),
                                                 mesh, rules)
                group = stack._groups(held["blocks"])[0]
                axes = tree_mod.tree_map(lambda a: a[1:],
                                         par.axes["blocks"])
                for (path, h), (_, c) in zip(
                        tree_mod.leaves_with_paths(group),
                        tree_mod.leaves_with_paths(par.compute(group, axes))):
                    shapes["/".join(path)] = (tuple(h.local.shape),
                                              tuple(c.shape))
                tok = held["embed"]["tok"]
                shapes["embed/tok"] = (tuple(tok.to_local().shape), tuple(
                    par.top(held, "embed")["tok"].shape))
            out[f"{arch}/{kind}/shapes"] = shapes
            out[f"{arch}/{kind}/tp"] = dict(par.tp)
            if kind == "serve":
                continue
            b = {k: (torch.cat([v, v]) if kind == "train_fsdp" else v)
                 for k, v in batch.items()}
            state = steps.shard_train_state(
                {"params": tree_mod.tree_map(lambda t: t.clone(), params),
                 "opt": adamw.init(params)}, cfg, mesh, rules)
            seen = []

            def spy(opt_cfg, grads, opt_state, params):
                seen.append(tree_mod.tree_map(_full, grads))
                return real_update(opt_cfg, grads, opt_state, params)
            adamw.update = spy
            try:
                step = steps.build_train_step(cfg, opt_cfg, mesh, rules)
                _, metrics = step(state, partition.distribute_tree(
                    b, {k: ("batch",) + (None,) * (v.dim() - 1)
                        for k, v in b.items()}, mesh, rules))
            finally:
                adamw.update = real_update
            out[f"{arch}/{kind}"] = {"loss": float(metrics["loss"]),
                                     "grad_norm": float(metrics["grad_norm"]),
                                     "grads": seen[0]}
    return out


def job_moe(rank, world, workdir):
    """The sharded `moe_ep` at ep=4 (a (2, 4) mesh, 8 experts of the
    reduced qwen3-moe) against the one-device route: the output, aux, and
    the gradients of sum(y * r) with respect to x and the experts."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.sharding import partition
    inp = _load_tree(workdir / "moe.npz")
    spec = moe.MoESpec(**json.loads((workdir / "moe.json").read_text()))
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"))
    rules = partition.make_rules("serve")
    batch_axes = rules.batch_axes
    x_full = inp["x"]
    xd = partition.distribute(x_full, mesh, partition.to_placements(
        ("batch", None, None), rules, mesh))
    held, leaves = {}, {}
    for name, axes in (("w1", ("expert", "embed_nofsdp", "expert_mlp")),
                       ("w3", ("expert", "embed_nofsdp", "expert_mlp")),
                       ("w2", ("expert", "expert_mlp", "embed_nofsdp")),
                       ("w_router", ("embed_nofsdp", None))):
        held[name] = partition.Held.of(partition.distribute(
            inp[name], mesh, partition.to_placements(axes, rules, mesh)))
        leaves[name] = held[name].local.clone().requires_grad_()
    # what the stack computes with: the experts split over the ep axis
    params = {k: dataclasses.replace(h, local=leaves[k]).compute(
        moe.ep_placements(h.placements, mesh, spec, 0) if k != "w_router"
        else h.placements, batch_axes) for k, h in held.items()}
    x = partition.keep_batch(xd, batch_axes).clone().requires_grad_()
    y, aux = moe.moe_ep(params, x, spec, mesh, batch_axes)
    r = partition.keep_batch(partition.distribute(
        inp["r"], mesh, xd.placements), batch_axes)
    # each rank's share of the global sum(y * r): its batch shard, once
    # over the ep ranks (their y are equal)
    (y * r).sum().backward()
    y_full = partition.batch_dtensor(y.detach(), mesh, batch_axes)
    gx = partition.batch_dtensor(x.grad, mesh, batch_axes)
    out = {"y": _full(y_full), "aux": float(aux), "gx": _full(gx)}
    for k, h in held.items():
        g = partition.reduce_replicated(leaves[k].grad, h, batch_axes)
        out["g" + k] = _full(h.dtensor(g))
    return out


def _full_tree(tree):
    from repro_torch import tree as tree_mod
    return tree_mod.tree_map(_full, tree)


def job_train(rank, world, workdir):
    """Reduced llama3.2-3b on a (world, 1) ("data", "model") mesh under
    the "train" rules: one sharded train step (fp32 compute), and one with
    gradient compression, each state gathered whole after it; the
    compressed step's state saved (rank 0 writes); the reference's
    checkpoint restored onto the phase-0 and the elastic phase-1
    placements; and the driver's elastic switch."""
    import torch
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.launch.train import TrainRun, train
    from repro_torch.models import convert
    from repro_torch.optim import adamw, grad_compress as gc
    from repro_torch.sharding import partition
    case = json.loads((workdir / "train.json").read_text())
    cfg = _cfg("llama3.2-3b")
    params = convert.params_from_numpy(
        _load_tree(workdir / "train_params.npz"), cfg, "cpu")
    tokens = _load_tree(workdir / "train_io.npz")["tokens"]
    opt_cfg = adamw.AdamWConfig(**case["opt"])
    mesh = mesh_mod.make_mesh((world, 1), ("data", "model"))
    out = {}
    for phase in (0, 1):
        rules = partition.make_rules(
            "train", overrides={"embed": None} if phase else None)
        batch = partition.distribute_tree(
            {"tokens": tokens}, {"tokens": ("batch", None)}, mesh, rules)
        for compress in (False, True):
            state = _clone_tree({"params": params,
                                 "opt": adamw.init(params)})
            if compress:
                state["ef"] = gc.init_error_feedback(state["params"])
            state = steps.shard_train_state(state, cfg, mesh, rules)
            step = steps.build_train_step(cfg, opt_cfg, mesh, rules,
                                          grad_compress=compress)
            state, metrics = step(state, batch)
            tag = f"p{phase}_c{int(compress)}"
            out[tag] = {"loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "state": _full_tree(state)}
            if compress and phase == 0:
                CheckpointManager(workdir / "ck_port").save(
                    1, state, blocking=True)
        like = steps.abstract_train_state(cfg)
        pls = partition.tree_placements(steps.train_state_axis_specs(cfg),
                                        rules, mesh)
        restored = CheckpointManager(workdir / "ck_ref").restore(
            case["ref_step"], like, "cpu", mesh, pls)
        out[f"restored_p{phase}"] = _full_tree(restored)
        out[f"restored_p{phase}_local"] = {
            "wo": restored["params"]["blocks"]["sub0"]["attn"]["wo"]
            .to_local().clone()}
    logs = []
    hist = train(TrainRun(arch="granite-3-8b", steps=16, global_batch=4,
                          seq_len=32, ckpt_dir=str(workdir / "ck_elastic"),
                          elastic_switch_step=8, log_every=1, device="cpu"),
                 log=logs.append)
    out["elastic"] = {"hist": hist, "logs": logs}
    return out


def _clone_tree(tree):
    from repro_torch import tree as tree_mod
    return tree_mod.tree_map(lambda t: t.clone(), tree)


def case_cfg(case: dict):
    """A case's config: the arch's reduced one in fp32 (`_cfg`, without
    its MoE route) with the case's field overrides (`over`) and MoE
    overrides (`moe`)."""
    import torch
    from repro_torch import configs
    cfg = dataclasses.replace(
        configs.get(case["arch"], reduced=True), param_dtype=torch.float32,
        compute_dtype=torch.float32, kv_dtype=torch.float32,
        **case.get("over", {}))
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return cfg


def job_split(rank, world, workdir):
    """The cases of `split.json`, each a config (`case_cfg`) on its mesh:
    under
    "train" one step (loss, grad norm, the gradient the optimizer takes,
    whole; the rows of the sequence each sub-layer's input holds; what
    rank 0 computes its attention with), under "serve" the prefill and
    two decode steps' logits on the sequence-sharded cache, and with
    "serve_driver" `launch.serve.serve` over every rank (its (1, world)
    mesh)."""
    import torch
    from repro_torch import tree as tree_mod
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.launch.serve import ServeRun, serve
    from repro_torch.models import api, convert, stack
    from repro_torch.models.api import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    cases = json.loads((workdir / "split.json").read_text())
    opt_cfg = adamw.AdamWConfig(**cases["opt"])
    out = {}
    real_update, real_sublayer = adamw.update, stack._sublayer
    for case in cases["cases"]:
        name = case["name"]
        if case.get("serve_driver"):
            res = serve(ServeRun(**case["serve_driver"]), log=lambda *_: None)
            out[f"{name}/serve_logits"] = res["logits"].detach().clone()
            continue
        cfg = case_cfg(case)
        mesh = mesh_mod.make_mesh(tuple(case["mesh"][0]),
                                  tuple(case["mesh"][1]))
        params = convert.params_from_numpy(
            _load_tree(workdir / f"{name}_params.npz"), cfg, "cpu")
        io_np = _load_tree(workdir / f"{name}_io.npz")
        if "train" in case["kinds"]:
            rules = partition.make_rules("train")
            with partition.use_rules(rules):
                par = stack.parallel(cfg, mesh, rules.batch_axes)
                held = partition.distribute_tree(params, api.param_specs(cfg),
                                                 mesh, rules)
                group = stack._groups(held["blocks"])[0]
                axes = tree_mod.tree_map(lambda a: a[1:], par.axes["blocks"])
                sub = next((k for k in sorted(group) if "attn" in group[k]),
                           None)
                if sub is not None:
                    used = par.compute(group[sub]["attn"],
                                       axes[sub]["attn"], "attn")
                    out[f"{name}/attn_used"] = {
                        k: tuple(v.shape) for k, v in used.items()}
            out[f"{name}/tp"] = dict(par.tp)
            state = steps.shard_train_state(
                {"params": tree_mod.tree_map(lambda t: t.clone(), params),
                 "opt": adamw.init(params)}, cfg, mesh, rules)
            seen, rows = [], []

            def spy(opt_cfg, grads, opt_state, params):
                seen.append(tree_mod.tree_map(_full, grads))
                return real_update(opt_cfg, grads, opt_state, params)

            def sublayer(sub, cfg, item, h, *a, **k):
                rows.append(int(h.shape[1]))
                return real_sublayer(sub, cfg, item, h, *a, **k)
            adamw.update, stack._sublayer = spy, sublayer
            try:
                step = steps.build_train_step(cfg, opt_cfg, mesh, rules)
                batch = {"tokens": io_np["train_tokens"]}
                _, metrics = step(state, partition.distribute_tree(
                    batch, {"tokens": ("batch", None)}, mesh, rules))
            finally:
                adamw.update, stack._sublayer = real_update, real_sublayer
            out[f"{name}/train"] = {"loss": float(metrics["loss"]),
                                    "grad_norm": float(metrics["grad_norm"]),
                                    "grads": seen[0], "rows": rows}
        if "serve" in case["kinds"]:
            rules = partition.make_rules("serve")
            p_serve = partition.distribute_tree(params, api.param_specs(cfg),
                                                mesh, rules)
            prompt = io_np["prompt"]
            b, s = prompt.shape

            def put(t):
                return partition.distribute(t, mesh, partition.to_placements(
                    ("batch", None), rules, mesh))
            cell = ShapeCell("p", s + case["new"], b, "prefill")
            with torch.inference_mode():
                prefill = steps.build_prefill_step(cfg, cell, mesh, rules)
                decode = steps.build_decode_step(cfg, mesh, rules)
                cache, logits = prefill(p_serve, {"tokens": put(prompt)})
                got = [_full(logits)]
                tok = got[0].argmax(-1)[:, None].to(torch.int32)
                for i in range(case["new"] - 1):
                    cache, nxt, logits = decode(p_serve, cache, put(tok),
                                                s + i)
                    got.append(_full(logits))
                    tok = _full(nxt)[:, None]
            out[f"{name}/serve_logits"] = torch.stack(got, 1)
    return out


JOBS = {"placements": job_placements, "models": job_models,
        "moe": job_moe, "train": job_train, "train_tp": job_train_tp,
        "split": job_split}


if __name__ == "__main__":
    import torch.multiprocessing as mp
    sys.path.insert(0, str(ROOT / "src"))
    job, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_main, args=(job, world, workdir), nprocs=world, join=True)


def job_gpipe(rank, world, workdir):
    """`gpipe_apply` on a (pod=2, data=2) mesh, 2 stages of 2 layers, for
    n_micro 2, 4 and 8: stage params whole on every rank, and as DTensors
    split over "pod"."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import partition
    from repro_torch.sharding.pipeline_parallel import gpipe_apply, \
        split_stages
    inp = _load_tree(workdir / "gpipe.npz")
    mesh = mesh_mod.make_mesh((2, 2), ("pod", "data"))

    def stage_fn(params, h):
        ws, bs = params
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i] + bs[i])
        return h

    whole = split_stages((inp["w"], inp["b"]), 2)
    split = tuple(partition.distribute(a, mesh, [Shard(0), Replicate()])
                  for a in whole)
    out = {}
    for n_micro in (2, 4, 8):
        for name, params in (("whole", whole), ("split", split)):
            out[f"{name}_{n_micro}"] = gpipe_apply(
                stage_fn, params, inp["x"], mesh=mesh, axis="pod",
                n_micro=n_micro)
    return out


JOBS["gpipe"] = job_gpipe
