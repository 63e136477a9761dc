"""Step builders that combine model, optimizer and sharding rules.

Mirrors `repro/launch/steps.py`.  A train state is a plain dict {"params",
"opt"} (plus "ef", the error feedback, with gradient compression); its
logical-axes tree mirrors it, so the placements derive mechanically.
Under a mesh the state's tensors are DTensors at those placements and each
step runs on every rank as its own program (`stack.local_loss` under
`stack.parallel`): each param's shard is cast to the compute dtype
where it lies, gathered layer group by layer group over the batch axes
(FSDP) and kept split over the tensor-parallel ones; the gradient of a
gathered dim comes back reduce-scattered over the batch ranks, that of a
dim the param is replicated on is all-reduced over them
(`partition.reduce_replicated`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import Replicate

from repro_torch import tree
from repro_torch.models import api, io, stack
from repro_torch.models.api import ModelConfig, ShapeCell
from repro_torch.optim import adamw, grad_compress as gc
from repro_torch.sharding import partition


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> dict:
    """{"params", "opt"} on `device`.  The params are drawn on the
    generator's device (`api.init_params`) and then moved, so a CPU
    generator gives the same weights on every device."""
    dev = api.resolve_device(device)
    params = api.init_params(cfg, generator)
    params = tree.tree_map(lambda leaf: leaf.to(dev), params)
    return {"params": params, "opt": adamw.init(params)}


def abstract_train_state(cfg: ModelConfig) -> dict:
    """The train state as `meta` tensors (nothing allocated)."""
    params = api.abstract_params(cfg)
    zeros = tree.tree_map(torch.empty_like, params)
    return {"params": params,
            "opt": {"m": zeros, "v": zeros,
                    "count": torch.empty((), dtype=torch.int32,
                                         device="meta")}}


def train_state_axis_specs(cfg: ModelConfig, grad_compress: bool = False):
    axes = api.param_specs(cfg)
    out = {"params": axes, "opt": {"m": axes, "v": axes, "count": ()}}
    if grad_compress:
        out["ef"] = axes
    return out


def shard_train_state(state: dict, cfg: ModelConfig, mesh, rules) -> dict:
    """`state` (whole and equal on every rank) as DTensors at the rules'
    placements: each rank keeps its slices."""
    return partition.distribute_tree(
        state, train_state_axis_specs(cfg, "ef" in state), mesh, rules)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def _compute_cast(cfg: ModelConfig, p: torch.Tensor) -> torch.Tensor:
    """Mixed precision with fp32 masters: each matrix (2 or more dims) is
    cast to the compute dtype once a step, inside autograd, so its
    gradient comes back to fp32 through the cast, as the reference's cast
    transpose does.  1-D params (norm scales, biases, a_log...) stay
    fp32."""
    if p.dim() >= 2 and p.dtype == torch.float32:
        return p.to(cfg.compute_dtype)
    return p


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     mesh=None, rules: partition.AxisRules | None = None,
                     grad_compress: bool = False,
                     cast_params_once: bool = True):
    """train_step(state, batch) -> (state, metrics).  The state's tensors
    are updated in place (`adamw.update`) and returned; metrics are
    {"loss", "grad_norm", "lr"}, scalar tensors on the state's device.

    `cast_params_once`: each fp32 matrix is cast to the compute dtype once
    a step, inside autograd (under a mesh on its local shard, before the
    gather, which halves the gathered bytes); otherwise each layer casts
    where it uses it (under a mesh after the gather).  Under a mesh (with
    `rules`) the state is DTensors (`shard_train_state`) and `batch`
    DTensors sharded over the batch axes (or this rank's shard as plain
    tensors)."""
    def cast(p):
        return _compute_cast(cfg, p) if cast_params_once else p

    if mesh is None:
        loss_fn = stack.build_loss_fn(cfg)

        def grads_of(params, batch):
            masters = tree.leaves(params)
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in masters]
                loss = loss_fn(tree.unflatten(params, [cast(p) for p in
                                                       leaves]), batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss, [torch.zeros_like(p) if g is None else g
                          for p, g in zip(masters, grads)]
    else:
        batch_axes = rules.batch_axes

        def grads_of(params, batch):
            masters = tree.leaves(params)
            held = [partition.Held.of(p) for p in masters]
            with torch.enable_grad():
                leaves = [h.local.detach().requires_grad_() for h in held]
                used = [dataclasses.replace(h, local=cast(leaf))
                        for h, leaf in zip(held, leaves)]
                loss = stack.local_loss(
                    tree.unflatten(params, used), cfg,
                    stack.local_batch(batch, batch_axes),
                    stack.parallel(cfg, mesh, batch_axes))
                grads = list(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))
            out = []
            for i, (p, h) in enumerate(zip(masters, held)):
                g, grads[i] = grads[i], None    # freed as it is reduced
                g = torch.zeros_like(h.local) if g is None else g
                g = partition.reduce_replicated(g, h, batch_axes)
                out.append(h.dtensor(g.to(p.dtype)))
            return loss, out

    def train_step(state, batch):
        with partition.use_rules(rules):
            loss, grads = grads_of(state["params"], batch)
            grads = tree.unflatten(state["params"], grads)
            if grad_compress:
                grads, ef = gc.compress_grads(grads, state["ef"])
            params, opt, metrics = adamw.update(
                opt_cfg, grads, state["opt"], state["params"])
        new_state = {"params": params, "opt": opt}
        if grad_compress:
            new_state["ef"] = ef
        return new_state, dict(metrics, loss=loss.detach())

    return train_step


def build_prefill_step(cfg: ModelConfig, cell: ShapeCell, mesh=None,
                       rules: partition.AxisRules | None = None):
    """prefill(params, batch) -> (cache, last_logits) for the cell's
    sequence length, under the rules."""
    batch_axes = rules.batch_axes if rules is not None else ("data",)
    prefill = stack.build_prefill_fn(cfg, max_len=cell.seq_len, mesh=mesh,
                                     batch_axes=batch_axes)

    def prefill_step(params, batch):
        with partition.use_rules(rules):
            return prefill(params, batch)

    return prefill_step


def build_decode_step(cfg: ModelConfig, mesh=None,
                      rules: partition.AxisRules | None = None):
    """decode(params, cache, tokens, pos) -> (cache, next_tok, logits)."""
    batch_axes = rules.batch_axes if rules is not None else ("data",)
    decode = stack.build_decode_fn(cfg, mesh=mesh, batch_axes=batch_axes)

    def decode_step(params, cache, tokens, pos):
        with partition.use_rules(rules):
            return decode(params, cache, tokens, pos)

    return decode_step


# ---------------------------------------------------------------------------
# placements for a (cfg, cell) pair
# ---------------------------------------------------------------------------


def cell_placements(cfg: ModelConfig, cell: ShapeCell, mesh,
                    rules: partition.AxisRules):
    """(in_placements, out_placements) of the cell's step function, trees
    of per-mesh-dim placement lists (the reference's `cell_shardings`
    without donation: the port's steps write their state in place)."""
    rep = [Replicate()] * mesh.ndim

    def place(axes_tree):
        return partition.tree_placements(axes_tree, rules, mesh)

    in_axis = io.input_axis_specs(cfg, cell)
    if cell.kind == "train":
        state_pl = place(train_state_axis_specs(cfg))
        batch_pl = place(in_axis["batch"])
        metrics_pl = {"grad_norm": rep, "lr": rep, "loss": rep}
        return (state_pl, batch_pl), (state_pl, metrics_pl)
    if cell.kind == "prefill":
        return ((place(api.param_specs(cfg)), place(in_axis["batch"])),
                (place(stack.cache_axis_specs(cfg)), rep))
    return ((place(api.param_specs(cfg)), place(in_axis["cache"]),
             place(in_axis["tokens"]), rep),
            (place(in_axis["cache"]), place(("batch",)),
             place(("batch", "vocab"))))


def abstract_inputs(cfg: ModelConfig, cell: ShapeCell):
    """Abstract argument tuple (`meta` tensors) of the cell's step."""
    specs = io.input_specs(cfg, cell)
    if cell.kind == "train":
        return (abstract_train_state(cfg), specs["batch"])
    if cell.kind == "prefill":
        return (api.abstract_params(cfg), specs["batch"])
    return (api.abstract_params(cfg), specs["cache"], specs["tokens"],
            specs["pos"])


def step_for_cell(cfg: ModelConfig, cell: ShapeCell, mesh, rules,
                  opt_cfg: adamw.AdamWConfig | None = None):
    if cell.kind == "train":
        return build_train_step(cfg, opt_cfg or adamw.AdamWConfig(),
                                mesh, rules)
    if cell.kind == "prefill":
        return build_prefill_step(cfg, cell, mesh, rules)
    return build_decode_step(cfg, mesh, rules)
