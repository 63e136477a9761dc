"""Step builders that combine the model and the optimizer.

Mirrors the one-device part of `repro/launch/steps.py`.  A train state is
a plain dict {"params", "opt"} (plus "ef", the error feedback, with
gradient compression).  The sharded parts of the reference's module (the
axis specs, `cell_shardings`, `abstract_inputs`, `step_for_cell`) come
with distribution.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import api, stack
from repro_torch.models.api import ModelConfig, ShapeCell
from repro_torch.optim import adamw, grad_compress as gc


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


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def _compute_cast(cfg: ModelConfig, p: torch.Tensor) -> torch.Tensor:
    """Mixed precision with fp32 masters: each matrix (2 or more dims) is
    cast to the compute dtype once a step, inside autograd, so its
    gradient comes back to fp32 through the cast, as the reference's cast
    transpose does.  1-D params (norm scales, biases, a_log...) stay
    fp32.  The reference can instead leave the cast to each layer
    (`cast_params_once=False`), which only matters where its params are
    sharded: the port always casts once."""
    if p.dim() >= 2 and p.dtype == torch.float32:
        return p.to(cfg.compute_dtype)
    return p


def build_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     grad_compress: bool = False):
    """train_step(state, batch) -> (state, metrics).  The state's tensors
    are updated in place (`adamw.update`) and returned; metrics are
    {"loss", "grad_norm", "lr"}, scalar tensors on the state's device."""
    loss_fn = stack.build_loss_fn(cfg)

    def train_step(state, batch):
        masters = tree.leaves(state["params"])
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_() for p in masters]
            used = [_compute_cast(cfg, p) for p in leaves]
            loss = loss_fn(tree.unflatten(state["params"], used), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree.unflatten(state["params"], (
            torch.zeros_like(p) if g is None else g
            for p, g in zip(masters, grads)))
        if grad_compress:
            grads, ef = gc.compress_grads(grads, state["ef"])
        params, opt, metrics = adamw.update(
            opt_cfg, grads, state["opt"], state["params"])
        new_state = {"params": params, "opt": opt}
        if grad_compress:
            new_state["ef"] = ef
        return new_state, dict(metrics, loss=loss.detach())

    return train_step


def build_prefill_step(cfg: ModelConfig, cell: ShapeCell):
    """prefill(params, batch) -> (cache, last_logits) for the cell's
    sequence length (the reference's adds the sharding rules)."""
    return stack.build_prefill_fn(cfg, max_len=cell.seq_len)


def build_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens, pos) -> (cache, next_tok, logits)."""
    return stack.build_decode_fn(cfg)
