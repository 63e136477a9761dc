"""Logical-axis -> mesh-axis partitioning rules, onto a `DeviceMesh`.

Mirrors `repro/sharding/partition.py`.  Model code tags params, inputs and
caches with *logical* axis names (`repro_torch.models.api.param_specs`,
`repro_torch.models.io.input_axis_specs`, `stack.cache_axis_specs`).  A
rule set maps logical names to mesh axes; this module turns an axes tuple
into DTensor placements (one per mesh dimension) and distributes trees of
tensors by them.

`AxisRules`, `flat_axes`, `make_rules`, `use_rules` and `active_rules` are
the reference's code (held to it by `tests/test_torch_core.py`).  Where
the reference builds a `PartitionSpec` (one entry per tensor dim), a
DTensor takes one `Placement` per mesh dim; `to_placements` converts.

A tensor dim mapped to a tuple of mesh axes (`("pod", "data")` for the
multi-pod batch, `("data", "model")` for `train_fsdp`'s embed) is split
major to minor in the tuple's order in JAX.  DTensor splits a dim sharded
over several mesh dims in mesh-dim order, so the two agree when the tuple
lists its axes in the mesh's order, and `to_placements` raises otherwise.
JAX requires every sharded dim to divide evenly; DTensor also takes an
uneven one (torch.chunk's split, the last shards short or empty), which
only the port's sequence-sharded cache uses (see layers.py).

Axis vocabulary:
  params:  layers, embed (fsdp-able), embed_nofsdp, q_proj, kv_proj, mlp,
           vocab, expert, expert_mlp, inner, heads_ssm
  data:    batch, seq, seq_kv, kv_heads_kv
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree as tree_mod


MeshAxes = Any  # str | tuple[str, ...] | None


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Mapping[str, MeshAxes]

    def get(self, name: str | None) -> MeshAxes:
        if name is None:
            return None
        if name not in self.rules:
            raise KeyError(f"no rule for logical axis {name!r}")
        return self.rules[name]

    @property
    def batch_axes(self):
        """Raw rule value for "batch" (None | str | tuple of str)."""
        return self.get("batch")


def flat_axes(value) -> tuple:
    """Flatten a rule value into a tuple of mesh-axis names (drops None)."""
    if value is None:
        return ()
    if isinstance(value, (tuple, list)):
        out = []
        for v in value:
            out.extend(flat_axes(v))
        return tuple(out)
    return (value,)


def make_rules(kind: str, multi_pod: bool = False,
               overrides: Mapping[str, MeshAxes] | None = None) -> AxisRules:
    """kind: "train" | "serve"."""
    batch = ("pod", "data") if multi_pod else ("data",)
    base = {
        "layers": None,
        "batch": batch,
        "seq": None,
        "q_proj": "model",
        "kv_proj": "model",
        "heads": "model",
        "seq_attn": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "inner": "model",
        "heads_ssm": "model",
        "embed_nofsdp": None,
        "embed_act": None,
    }
    if kind == "train":
        base["embed"] = "data"      # ZeRO-3 / FSDP over the data axis
        base["seq"] = "model"       # Megatron-style sequence parallelism
        base["seq_kv"] = None       # caches unused in training
        base["kv_heads_kv"] = None
    elif kind == "train_fsdp":
        # pure FSDP (ZeRO-3 over the whole mesh, no tensor parallelism);
        # MoE keeps TP/EP (the expert axis needs "model")
        batch_all = batch + ("model",)
        base.update({
            "batch": batch_all,
            "embed": ("data", "model"),
            "seq": None,
            "q_proj": None, "kv_proj": None, "heads": None,
            "mlp": None, "vocab": None, "inner": None,
            "heads_ssm": None, "expert": None, "expert_mlp": None,
            "seq_kv": None, "kv_heads_kv": None,
        })
    elif kind == "serve":
        base["embed"] = None        # latency path: TP only
        # KV caches are SEQUENCE-sharded over the TP axis (works for any
        # kv_heads vs TP degree; see layers.sharded_cache_attention)
        base["seq_kv"] = "model"
        base["kv_heads_kv"] = None
    else:
        raise ValueError(kind)
    if overrides:
        base.update(overrides)
    return AxisRules(base)


# ---------------------------------------------------------------------------
# axes -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(axes: tuple, rules: AxisRules, mesh) -> list:
    """One placement per mesh dim: `Shard(d)` on each mesh axis the rule
    of tensor dim d names, `Replicate()` on the rest."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, logical in enumerate(axes):
        mesh_axes = flat_axes(rules.get(logical))
        idx = []
        for a in mesh_axes:
            if a not in names:
                raise KeyError(f"axis {a!r} of rule {logical!r} is not a "
                               f"dim of the mesh {tuple(names)}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{axes}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"rule {logical!r} -> {mesh_axes} lists mesh axes out of "
                f"the mesh's order {tuple(names)}: DTensor would split the "
                f"dim in another order than JAX")
        for i in idx:
            out[i] = Shard(d)
    return out


def is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def tree_placements(axes_tree, rules: AxisRules, mesh):
    """The axes tree's placements, leaf for leaf."""
    if is_axes(axes_tree):
        return to_placements(axes_tree, rules, mesh)
    return {k: tree_placements(v, rules, mesh) for k, v in axes_tree.items()}


def distribute(x: torch.Tensor, mesh, placements) -> DTensor:
    """`x` (the same full tensor on every rank) as a DTensor: each rank
    keeps its slice, nothing is sent.  DTensor's split (torch.chunk per
    mesh dim, in mesh-dim order, the last chunks empty where the dim
    runs out), taken as a view: only a slice that is not contiguous is
    copied, so at one rank the DTensor holds `x` itself
    (`distribute_tensor` clones every shard, which doubles a train state
    in memory)."""
    local = x
    _, sizes, coord = geometry(mesh)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = sizes[i]
            chunks = torch.chunk(local, n, dim=p.dim)
            local = (chunks[coord[i]] if coord[i] < len(chunks)
                     else local.narrow(p.dim, local.shape[p.dim], 0))
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              shape=x.shape, stride=x.stride())


def distribute_tree(tree, axes_tree, mesh, rules: AxisRules):
    """Every leaf of `tree` (full and equal on every rank) distributed by
    the placements of its logical axes."""
    return tree_mod.tree_map(
        lambda x, pl: distribute(x, mesh, pl), tree,
        tree_placements(axes_tree, rules, mesh))


def zeros(shape, dtype, mesh, placements) -> DTensor:
    """A zero DTensor of global `shape`: each rank allocates its slice."""
    from torch.distributed.tensor import zeros as dt_zeros
    return dt_zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                    placements=placements)


def split_axes(x, dim: int | None = None) -> tuple:
    """The mesh axes that split a DTensor (those that split tensor dim
    `dim`, when given); none for a plain tensor."""
    if not isinstance(x, DTensor):
        return ()
    names = geometry(x.device_mesh)[0]
    return tuple(names[i] for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and dim in (None, p.dim))


def local(x):
    """A DTensor's local shard; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def full(x):
    """The whole tensor on every rank (an all-gather of a DTensor; a
    plain tensor as it is)."""
    if not isinstance(x, DTensor):
        return x
    return gather_to(x, [Replicate()] * x.device_mesh.ndim)


# ---------------------------------------------------------------------------
# mesh coordinates and collectives over named mesh axes
# ---------------------------------------------------------------------------


_GEOMETRY: dict = {}


def geometry(mesh) -> tuple:
    """(dim names, dim sizes, this rank's coordinate) of a mesh, read once
    (DeviceMesh answers each query through its tensors, ~50 µs, and a
    decode step asks a few hundred times)."""
    hit = _GEOMETRY.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        coord = mesh.get_coordinate()
        hit = (mesh, (tuple(mesh.mesh_dim_names),
                      tuple(mesh.size(i) for i in range(mesh.ndim)),
                      None if coord is None else tuple(coord)))
        _GEOMETRY[id(mesh)] = hit
    return hit[1]


def axis_size(mesh, axes) -> int:
    names, sizes, _ = geometry(mesh)
    n = 1
    for a in flat_axes(axes):
        n *= sizes[names.index(a)]
    return n


def axis_index(mesh, axes) -> int:
    """This rank's index along the flattened mesh axes, major to minor in
    their order (the reference's `idx * mesh.shape[a] + axis_index(a)`)."""
    names, sizes, coord = geometry(mesh)
    idx = 0
    for a in flat_axes(axes):
        d = names.index(a)
        idx = idx * sizes[d] + coord[d]
    return idx


def all_reduce(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """In place over the ranks that differ only along `axes` (one
    collective per mesh axis; SUM and MAX are associative).  Returns x."""
    names, sizes, _ = geometry(mesh)
    for a in flat_axes(axes):
        if sizes[names.index(a)] > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over a group of ranks whose downstream computation is the same
    on each: all-reduce forward, identity backward (Megatron's `g`)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyToGroup(torch.autograd.Function):
    """The same input on every rank of a group whose ranks each use it for
    a part of the result: identity forward, gradient all-reduced backward
    (Megatron's `f`)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.mesh, ctx.axes), None, None


class _SumOverGroup(torch.autograd.Function):
    """Sum over a group of ranks each of which then computes its own part
    with the sum: all-reduce forward, and the gradients of those parts
    all-reduced backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.mesh, ctx.axes), None, None


def sum_over_group(x, mesh, axes):
    return _SumOverGroup.apply(x, mesh, axes)


def reduce_from_group(x, mesh, axes):
    return _ReduceFromGroup.apply(x, mesh, axes)


def copy_to_group(x, mesh, axes):
    return _CopyToGroup.apply(x, mesh, axes)


def _gather0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def gather_parts(x: torch.Tensor, mesh, axes) -> list:
    """Every rank's `x` (equal shapes) over the ranks that differ only
    along `axes`, in the order of `axis_index` (major to minor)."""
    names, sizes, _ = geometry(mesh)
    stacked = x[None]
    for a in reversed(flat_axes(axes)):
        n = sizes[names.index(a)]
        if n > 1:
            stacked = _gather0(stacked, mesh.get_group(a), n)
    return list(stacked.unbind(0))


def _all_gather_dim(x, mesh, axes, dim):
    """The ranks' x joined along `dim` in `axis_index` order (one
    all-gather per mesh axis, the minor one first)."""
    names, sizes, _ = geometry(mesh)
    x = x.movedim(dim, 0)
    for a in reversed(flat_axes(axes)):
        n = sizes[names.index(a)]
        if n > 1:
            x = _gather0(x, mesh.get_group(a), n)
    return x.movedim(0, dim).contiguous()


def _own_part(x, mesh, axes, dim):
    n = axis_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size).contiguous()


_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _reduce_scatter_dim(x, mesh, axes, dim):
    """The sum over the `axes` ranks of x, of which this rank keeps its
    equal part of `dim` (one reduce-scatter per mesh axis, the major one
    first)."""
    names, sizes, _ = geometry(mesh)
    x = x.movedim(dim, 0)
    for a in flat_axes(axes):
        n = sizes[names.index(a)]
        if n > 1:
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            _REDUCE_SCATTER(out, x.contiguous(), group=mesh.get_group(a))
            x = out
    return x.movedim(0, dim).contiguous()


class _GatherFromGroup(torch.autograd.Function):
    """Each rank's part of `dim` joined over a group whose ranks each use
    the whole for a part of the result: all-gather forward, the ranks'
    gradients summed and this rank's part kept backward (a reduce-scatter;
    Megatron's sequence-parallel `g`, in place of `copy_to_group`)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, *ctx.args), None, None, None


class _ScatterToGroup(torch.autograd.Function):
    """Partial sums over a group, of which each rank keeps its part of
    `dim`: reduce-scatter forward, all-gather backward (Megatron's
    sequence-parallel `g-bar`, in place of `reduce_from_group`)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _reduce_scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_dim(grad, *ctx.args), None, None, None


class _GatherWhole(torch.autograd.Function):
    """Each rank's part of `dim` joined over a group whose ranks then all
    compute the same thing with the whole: all-gather forward, this
    rank's part of the (equal) gradient kept backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_part(grad, *ctx.args), None, None, None


class _SplitToGroup(torch.autograd.Function):
    """This rank's part of `dim` of a tensor that is the same on every
    rank of a group: a slice forward, the parts all-gathered backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _own_part(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_dim(grad, *ctx.args), None, None, None


def gather_from_group(x, mesh, axes, dim: int):
    return _GatherFromGroup.apply(x, mesh, axes, dim)


def scatter_to_group(x, mesh, axes, dim: int):
    return _ScatterToGroup.apply(x, mesh, axes, dim)


def gather_whole(x, mesh, axes, dim: int):
    return _GatherWhole.apply(x, mesh, axes, dim)


def split_to_group(x, mesh, axes, dim: int):
    return _SplitToGroup.apply(x, mesh, axes, dim)


def tp_enter(x, mesh, tp, sp=()):
    """A tensor-parallel layer's input: the same x on every rank of `tp`
    (`copy_to_group`), or under sequence parallelism over the same axes
    (`sp`, then x is this rank's rows of dim 1) the rows all-gathered."""
    if sp:
        return gather_from_group(x, mesh, sp, 1)
    return copy_to_group(x, mesh, tp) if tp else x


def tp_leave(y, mesh, tp, sp=()):
    """A tensor-parallel layer's partial output summed over `tp`
    (`reduce_from_group`), or under sequence parallelism reduce-scattered
    to this rank's rows of dim 1."""
    if sp:
        return scatter_to_group(y, mesh, sp, 1)
    return reduce_from_group(y, mesh, tp) if tp else y


# ---------------------------------------------------------------------------
# the local island: what a rank computes with, and the way back
# ---------------------------------------------------------------------------


def _same_on_one(x: DTensor, placements) -> list:
    """`placements` with x's own placement kept on every mesh dim of size
    one, where a shard is the whole and moving it would only copy."""
    sizes = geometry(x.device_mesh)[1]
    return [x.placements[i] if sizes[i] == 1 else p
            for i, p in enumerate(placements)]


def gather_to(x: DTensor, placements) -> torch.Tensor:
    """The local tensor of `x` redistributed to `placements` (an
    all-gather over every mesh dim that goes from Shard to Replicate)."""
    placements = _same_on_one(x, placements)
    if tuple(placements) == tuple(x.placements):
        return x.to_local()
    return x.redistribute(x.device_mesh, placements).to_local()


def batch_dims(mesh, batch_axes) -> set:
    names = geometry(mesh)[0]
    return {names.index(a) for a in flat_axes(batch_axes)}


def _batch_kept(x: DTensor, batch_axes) -> list:
    keep = batch_dims(x.device_mesh, batch_axes)
    return [p if i in keep else Replicate()
            for i, p in enumerate(x.placements)]


def keep_batch(x, batch_axes) -> torch.Tensor:
    """This rank's batch shard of `x` with every other dim whole (an
    all-gather over the mesh dims that shard anything but the batch)."""
    if not isinstance(x, DTensor):
        return x
    return gather_to(x, _batch_kept(x, batch_axes))


def store_batch(x, new: torch.Tensor, batch_axes) -> None:
    """Write `new` (this rank's batch shard, every other dim whole, as
    `keep_batch` gives it) into x's local slice in place."""
    if not isinstance(x, DTensor):
        x.copy_(new)
        return
    pl = _batch_kept(x, batch_axes)
    src = DTensor.from_local(new, x.device_mesh, pl, shape=x.shape,
                             stride=x.stride())
    x.to_local().copy_(
        src.redistribute(x.device_mesh, x.placements).to_local())


def batch_dtensor(x: torch.Tensor, mesh, batch_axes) -> DTensor:
    """A rank's batch shard (dim 0) as the DTensor of the global batch,
    replicated over the other mesh dims."""
    keep = batch_dims(mesh, batch_axes)
    pl = [Shard(0) if i in keep else Replicate()
          for i in range(mesh.ndim)]
    shape = (x.shape[0] * axis_size(mesh, batch_axes),) + tuple(x.shape[1:])
    return DTensor.from_local(
        x.contiguous(), mesh, pl, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# a rank's shard of a param, and what it computes with
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Held:
    """A rank's shard of a param (`local`, the DTensor's local tensor; in
    a train step the leaf the gradient is taken for) and the layout it
    was cut from: the mesh, the storage placements, the global shape."""
    local: torch.Tensor
    mesh: Any
    placements: tuple
    shape: tuple

    @staticmethod
    def of(x: DTensor) -> "Held":
        return Held(x.to_local(), x.device_mesh, tuple(x.placements),
                    tuple(x.shape))

    def groups(self) -> list:
        """Each group of a stacked param (dim 0, which no rule splits),
        as the shard of the group's own tensor."""
        if any(isinstance(p, Shard) and p.dim == 0 for p in self.placements):
            raise ValueError("a stacked param split over its groups")
        pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for p in self.placements)
        return [Held(t, self.mesh, pl, self.shape[1:])
                for t in self.local.unbind(0)]

    def dtensor(self, local: torch.Tensor) -> DTensor:
        """`local` (a tensor of the shard's shape, e.g. its gradient) as
        the DTensor of this layout."""
        return _dtensor(local, self, self.placements)

    def compute(self, placements, batch_axes, summed=()) -> torch.Tensor:
        """The tensor this rank computes with: the shard all-gathered over
        every mesh dim where `placements` is Replicate and the storage is
        Shard (an FSDP gather over the batch axes, or a layer that does
        not compute on the split).  Differentiable: the gradient goes back
        onto the storage placements, summed over the batch ranks of the
        gathered dims and over those of the mesh axes `summed` (a
        reduce-scatter: each of those ranks computed with a part of the
        gathered tensor) and sliced on the others, whose ranks computed
        the same gradient.  A mesh dim of size one moves nothing."""
        _, sizes, _ = geometry(self.mesh)
        pl = tuple(s if n == 1 else p
                   for s, p, n in zip(self.placements, placements, sizes))
        if pl == self.placements:
            return self.local
        keep = batch_dims(self.mesh, batch_axes) | batch_dims(self.mesh,
                                                              summed)
        grad_pl = tuple(
            Partial() if i in keep and isinstance(s, Shard)
            and isinstance(p, Replicate) else p
            for i, (s, p) in enumerate(zip(self.placements, pl)))
        return _ToCompute.apply(self.local, self, pl, grad_pl)


def _dtensor(local, held: Held, placements) -> DTensor:
    return DTensor.from_local(
        local.contiguous(), held.mesh, placements, shape=held.shape,
        stride=torch.empty(held.shape, device="meta").stride())


class _ToCompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, held, placements, grad_placements):
        ctx.held, ctx.grad_placements = held, grad_placements
        return _dtensor(local, held, held.placements).redistribute(
            held.mesh, placements).to_local()

    @staticmethod
    def backward(ctx, grad):
        held = ctx.held
        g = _dtensor(grad, held, ctx.grad_placements).redistribute(
            held.mesh, held.placements).to_local()
        return g, None, None, None


def reduce_replicated(grad: torch.Tensor, held: Held, batch_axes):
    """A rank's gradient of its shard, summed in place over the batch
    mesh dims on which the param is replicated (each rank saw its own
    part of the batch; `Held.compute` summed the dims it gathered)."""
    names, sizes, _ = geometry(held.mesh)
    axes = [names[i] for i in batch_dims(held.mesh, batch_axes)
            if isinstance(held.placements[i], Replicate) and sizes[i] > 1]
    return all_reduce(grad, held.mesh, tuple(axes)) if axes else grad


# ---------------------------------------------------------------------------
# activation constraint context (used sparsely inside model code)
# ---------------------------------------------------------------------------

_ACTIVE: list[AxisRules | None] = [None]


class use_rules:
    def __init__(self, rules: AxisRules | None):
        self.rules = rules

    def __enter__(self):
        _ACTIVE.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.pop()


def active_rules() -> AxisRules | None:
    return _ACTIVE[-1]


def constrain(x, axes: tuple):
    """Redistribute a DTensor to the placements the active rules give
    `axes` (the reference's `with_sharding_constraint`).  The identity on
    a plain tensor: the model's per-rank bodies compute on local tensors."""
    rules = _ACTIVE[-1]
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          to_placements(axes, rules, x.device_mesh))
