"""Dispatch-level op, byte, FLOP and collective accounting of one rank's
step.

The counterpart of `repro/sharding/hlo_analysis.py`.  The reference reads
a compiled, partitioned program: XLA's cost analysis for FLOPs and bytes,
its memory analysis, and the HLO text for the collectives.  Eager PyTorch
compiles nothing, so there is no HLO to parse: what a rank runs is the
sequence of aten and c10d ops it dispatches.  `OpRecorder`, a
`TorchDispatchMode`, records each op once as it runs: its bytes (outputs
written plus operands read), its FLOPs (`torch.utils.flop_counter`'s
registry, the formulas `FlopCounterMode` uses), and for a collective the
reference's opcode name, the operand bytes and the size of the call's
process group.  It also follows the lifetime of every storage an op
creates, for the peak of live bytes.  Under `FakeTensorMode` (tensors with
shapes and no storage) and a `fake` process group, a step at any size and
world traces on one host and computes nothing.

Everything is per rank, as the reference's partitioned program is per
device; and every op the step runs is counted as often as it runs (loops
are unrolled in eager mode, a remat recomputation dispatches again), where
the reference's HLO counts a while-loop body once.

A DTensor op is not recorded itself: the mode declines it (returns
`NotImplemented`), DTensor runs its local ops and collectives, and those
are recorded.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's opcode names (`hlo_analysis.COLLECTIVES`)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")


def _c10d_ops() -> dict:
    """{op overload: (opcode, index of the operand, index of the process
    group, how the group is named)} for the collectives the port reaches:
    `dist.all_reduce` (`partition.all_reduce`), DTensor's redistributions
    (the functional collectives: `Held.compute` and its backward,
    `keep_batch`, `store_batch`) and `batch_isend_irecv` (GPipe; a send is
    the rank's share of a collective-permute, a receive is the peer's).
    "pg" is a boxed ProcessGroup, "name" a registered group name."""
    c10d = torch.ops.c10d
    fn = torch.ops._c10d_functional
    auto = torch.ops._c10d_functional_autograd
    return {
        c10d.allreduce_.default: ("all-reduce", 0, 1, "pg"),
        c10d._allgather_base_.default: ("all-gather", 1, 2, "pg"),
        c10d._reduce_scatter_base_.default: ("reduce-scatter", 1, 2, "pg"),
        c10d.alltoall_base_.default: ("all-to-all", 1, 2, "pg"),
        c10d.send.default: ("collective-permute", 0, 1, "pg"),
        fn.all_reduce.default: ("all-reduce", 0, 2, "name"),
        fn.all_reduce_.default: ("all-reduce", 0, 2, "name"),
        fn.all_gather_into_tensor.default: ("all-gather", 0, 2, "name"),
        auto.all_gather_into_tensor.default: ("all-gather", 0, 2, "name"),
        fn.reduce_scatter_tensor.default: ("reduce-scatter", 0, 3, "name"),
        auto.reduce_scatter_tensor.default: ("reduce-scatter", 0, 3,
                                             "name"),
        fn.all_to_all_single.default: ("all-to-all", 0, 3, "name"),
        auto.all_to_all_single.default: ("all-to-all", 0, 3, "name"),
        torch.ops._dtensor.shard_dim_alltoall.default: ("all-to-all", 0, 3,
                                                        "name"),
    }


# ops that allocate without writing a byte
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "new_empty",
                         "new_empty_strided", "empty_like"})
# ops whose output is a view of an input though their schema does not say
# so (matmul's reshape of its product)
_VIEW_LIKE = frozenset({"_unsafe_view", "lift_fresh"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _arg_tensors(args, kwargs) -> list:
    """The tensors among an aten op's arguments (a tensor, or a list of
    them, per argument)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _group_size(kind: str, arg) -> int:
    if kind == "pg":
        from torch._C._distributed_c10d import ProcessGroup
        return ProcessGroup.unbox(arg).size()
    from torch._C._distributed_c10d import _resolve_process_group
    return _resolve_process_group(arg).size()


@dataclasses.dataclass
class OpRecord:
    op: str               # the aten (or c10d) op, without its overload
    bytes: int            # operands read + outputs written
    flops: int = 0
    collective: str = ""  # the reference's opcode, for a collective
    operand: int = 0      # a collective's operand bytes (per device)
    group: int = 1        # a collective's group size


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active (`records`), and the
    live bytes of the storages the ops create: `live`, and `peak`, its
    largest value.  Storages marked with `mark_arguments` (the step's
    inputs) are not counted as created.  Holds no tensor: a storage is
    followed by a weak reference, so lifetimes are the program's own.
    Ops run under another fake mode than the one active on entry are
    DTensor's shape propagation, not the program's, and are not
    recorded."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.records: list[OpRecord] = []
        self.live = 0
        self.peak = 0
        self._flops = flop_registry
        self._collectives = _c10d_ops()
        self._kinds: dict = {}
        self._seen: dict = {}          # id(storage) -> weakref

    def __enter__(self):
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def mark_arguments(self, tree) -> None:
        for t in _tensors(tree):
            st = t.untyped_storage()
            self._seen[id(st)] = weakref.ref(st)

    def _created(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)
        self._seen[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _kind(self, func) -> tuple:
        """(name, which returns are written in place, whether a return
        is a view), read once per op from its schema."""
        kind = self._kinds.get(func)
        if kind is None:
            name = func.overloadpacket.__name__
            rets = func._schema.returns
            written = tuple(r.alias_info is not None and r.alias_info.is_write
                            for r in rets)
            viewed = name in _VIEW_LIKE or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)
            kind = self._kinds[func] = (name, written, viewed)
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:
            # DTensor's sharding propagation, on global shapes under a
            # fake mode of its own: no op of the rank's program
            return out
        outs = _tensors(out)
        coll = self._collectives.get(func)
        if not outs and coll is None:  # metadata: sizes, devices, a Work
            return out
        name, written, viewed = self._kind(func)
        if viewed or name in _NO_TRAFFIC:
            nbytes = 0
        elif name == "copy_":
            nbytes = 2 * _nbytes(args[0])          # read src, write dst
        elif name == "index_put_":
            nbytes = 2 * _nbytes(args[2])          # the piece, as DUS
        elif any(written):
            # in place (or into out=): the written tensors are among the
            # operands; count them once more as written
            nbytes = sum(map(_nbytes, _arg_tensors(args, kwargs))) + sum(
                _nbytes(t) for t, w in zip(outs, written) if w)
        else:
            nbytes = sum(map(_nbytes, _arg_tensors(args, kwargs))) + sum(
                map(_nbytes, outs))
        rec = OpRecord(name, nbytes)
        flops = self._flops.get(func.overloadpacket)
        if flops is not None:
            rec.flops = int(flops(*args, **kwargs, out_val=out))
        if coll is not None:
            opcode, ai, gi, kind = coll
            rec.collective = opcode
            rec.operand = sum(map(_nbytes, _tensors(args[ai])))
            rec.group = _group_size(kind, args[gi])
        self.records.append(rec)
        if not viewed and not any(written):
            for t in outs:
                self._created(t)
        return out


def total_flops(records) -> int:
    return sum(r.flops for r in records)


def flops_by_op(records) -> dict:
    out: dict = defaultdict(int)
    for r in records:
        if r.flops:
            out[r.op] += r.flops
    return dict(out)


def collective_bytes(records) -> dict:
    """Per-opcode operand bytes of the collectives (per device), the
    reference's dict: `per_op`, `counts`, `wire_per_op`, `total`,
    `wire_total`.

    `total` sums operand sizes.  `wire_total` estimates the bytes
    serialised through a device's links (ring algorithms, group size g of
    each call's process group): all-reduce 2(g-1)/g x operand;
    reduce-scatter/all-to-all/permute (g-1)/g x operand; all-gather
    (g-1) x operand (operand = one shard)."""
    out: dict = defaultdict(int)
    counts: dict = defaultdict(int)
    wire: dict = defaultdict(float)
    for r in records:
        if not r.collective:
            continue
        op, nbytes, g = r.collective, r.operand, r.group
        if op == "all-reduce":
            w = 2 * (g - 1) / max(g, 1) * nbytes
        elif op == "all-gather":
            w = (g - 1) * nbytes
        else:
            w = (g - 1) / max(g, 1) * nbytes
        out[op] += nbytes
        wire[op] += w
        counts[op] += 1
    return {"per_op": dict(out), "counts": dict(counts),
            "wire_per_op": {k: int(v) for k, v in wire.items()},
            "total": sum(out.values()),
            "wire_total": int(sum(wire.values()))}


def bytes_by_op(records, top: int = 15) -> dict:
    """Bytes (outputs written + operands read) per op, the `top` largest.

    Views, `detach`, aliases and metadata ops count 0; an allocation
    (`empty`) counts 0; `copy_` counts its piece read and written, and an
    `index_put_` (a cache write) twice the piece it writes, as the
    reference counts a `dynamic-update-slice`; another in-place op its
    operands and the tensor it writes."""
    out_bytes: dict = defaultdict(int)
    counts: dict = defaultdict(int)
    for r in records:
        if r.bytes:
            out_bytes[r.op] += r.bytes
            counts[r.op] += 1
    ranked = sorted(out_bytes.items(), key=lambda kv: -kv[1])[:top]
    return {op: {"bytes": b, "count": counts[op]} for op, b in ranked}


def hbm_model_bytes(records) -> int:
    """The step's device-memory traffic.  Eager PyTorch fuses nothing:
    every op reads its operands from device memory and writes its outputs
    back, so every op that moves bytes is an HBM round trip, and the sum
    over all ops is the model (the reference keeps the ops XLA would not
    fuse on a TPU, `HBM_REAL_OPS`)."""
    return sum(r.bytes for r in records)


def cost_analysis_dict(records) -> dict:
    """The reference's two cost keys: FLOPs, and bytes accessed (in eager
    mode the same bytes as `hbm_model_bytes`)."""
    return {"flops": float(total_flops(records)),
            "bytes accessed": float(hbm_model_bytes(records))}


def local_tensors(tree) -> list:
    """The tensors of a tree (nested dicts, lists, tuples), a DTensor as
    its local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def _storages(tree) -> dict:
    """{id(storage): a tensor on it} of a tree's local tensors (the
    tensor keeps its storage, and so the id, alive)."""
    out: dict = {}
    for t in local_tensors(tree):
        out.setdefault(id(t.untyped_storage()), t)
    return out


def _tree_bytes(tree) -> int:
    """Bytes of a tree's local tensors, each tensor once (a view of an
    argument counts its own size, not its storage's)."""
    return sum(_nbytes(t) for t in {id(t): t for t in
                                    local_tensors(tree)}.values())


def memory_stats_dict(recorder: OpRecorder, args, outputs) -> dict:
    """The reference's five memory keys for one traced step: the rank's
    argument bytes (its shards of params, state, cache and batch); output
    bytes; alias bytes (outputs on arguments' storage, written in place:
    the train state, the decode cache); temp bytes, the peak of the live
    bytes the step created over the arguments (the outputs it creates
    among them); no generated code."""
    arg_st = _storages(args)
    alias = sum(_nbytes(t) for k, t in _storages(outputs).items()
                if k in arg_st)
    return {"generated_code_size_in_bytes": 0,
            "argument_size_in_bytes": _tree_bytes(args),
            "output_size_in_bytes": _tree_bytes(outputs),
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": recorder.peak}
