"""AccelModule: a built program + weights, placeable into slots.

Mirrors `repro/core/module.py`.  FOS mapping:
  - build against a slot *interface* (shape + axes + abstract inputs), in
    isolation from the shell instance -> decoupled compilation;
  - placement into a congruent slot reuses the built program -> relocation
    (BitMan analogue);
  - weight upload to the slot's device = partial reconfiguration; the
    scheduler skips it when the module is already resident (paper 4.4.3).

PyTorch runs eagerly, so the port's "compile" is the builder plus one
warm-up call on zero inputs: the first call loads the nvcc-built kernel
libraries and the cuBLAS handles, so the first chunk does not pay for
them.  Grad mode, the current device and the current stream are
thread-local in PyTorch, and the daemon runs chunks in worker threads, so
`place` and `run_placement` set all three themselves.

A slot of several devices (`Slot.run_devices`) is the reference's slot
mesh, run by this one process: `place` uploads a weight replica to each
device and warms each up (the zoo's weights are replicated in the
reference too); `run_placement` splits each input along the dim its
`input_pspecs` entry shards (the reference's `P(axis, None)`), runs the
program on every device on that device's stream, and concatenates the
outputs on the slot's first device.  A program with `halo` rows gets that
many rows of each neighbour's part on each side of its own (zeros past
the edges, as a SAME convolution pads) and its outputs are cropped back,
so a stencil over row parts equals the stencil over the whole.

A ModuleBuilder (referenced by the registry descriptor's entrypoint) takes
`(slot, footprint)` and returns a ModuleProgram describing fn / abstract
inputs / weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core.shell import Slot


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of an abstract input or weight (the port's
    `jax.ShapeDtypeStruct`)."""
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def dtype_name(self) -> str:
        """The dtype as the reference names it ("float32", "int32")."""
        return str(self.dtype).removeprefix("torch.")

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


def tree_map(fn, tree):
    """fn over the leaves of nested dicts, lists and tuples; None stays
    None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class ModuleProgram:
    """What a builder returns for a given footprint."""
    fn: Callable                         # (weights, *chunk_args) -> outputs
    abstract_weights: Any                # tree of TensorSpec (or None)
    abstract_inputs: tuple               # chunk args, TensorSpecs
    init_weights: Callable | None = None  # CPU generator -> host weights
    # per chunk arg, its axes: the dim whose entry is not None is split
    # over the slot's devices (None or an all-None entry: every device
    # gets the whole arg)
    input_pspecs: tuple | None = None
    halo: int = 0                        # rows of context a split part needs

    def signature(self) -> dict:
        def leaf(s):
            return {"shape": list(s.shape), "dtype": s.dtype_name}
        return {
            "inputs": tree_map(leaf, list(self.abstract_inputs)),
            "weights": tree_map(leaf, self.abstract_weights),
        }


@dataclasses.dataclass
class Placement:
    """A module implementation resident in a slot."""
    module: "AccelModule"
    footprint: int
    slot: Slot
    executable: Callable                 # the program's fn
    weights_on_slot: Any                 # the replica on the first device
    load_time_s: float
    compile_time_s: float
    cache_hit: bool
    replicas: list | None = None         # one weight replica per device


@contextlib.contextmanager
def on_device(device: torch.device, stream):
    """Inference mode, the device and its stream as the current ones, for
    this thread."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        if stream is not None:
            stack.enter_context(torch.cuda.device(device))
            stack.enter_context(torch.cuda.stream(stream))
        yield


def on_slot(slot: Slot):
    """`on_device` for the slot's first device."""
    return on_device(slot.device, slot.stream)


def _sync(slot: Slot) -> None:
    for stream in slot.streams:
        if stream is not None:
            stream.synchronize()


def _to_slot(x, slot: Slot):
    return torch.as_tensor(x).to(slot.device)


def _split_dim(pspec) -> int | None:
    """The dim an input's axes tuple shards (None: not split)."""
    if pspec is None:
        return None
    dims = [i for i, a in enumerate(pspec) if a is not None]
    assert len(dims) <= 1, pspec
    return dims[0] if dims else None


def _parts(x: torch.Tensor, dim: int | None, k: int, halo: int) -> list:
    """x's k equal parts along `dim`, each with `halo` rows of its
    neighbours on either side (zeros past the edges); x itself k times
    when dim is None."""
    if dim is None:
        return [x] * k
    n = x.shape[dim]
    if n % k:
        raise ValueError(f"dim {dim} of size {n} does not split over {k} "
                         f"devices")
    c = n // k
    if halo:
        pad = [0, 0] * (x.dim() - dim - 1) + [halo, halo]
        x = torch.nn.functional.pad(x, pad)
    return [x.narrow(dim, i * c, c + 2 * halo) for i in range(k)]


def _crop(y, halo: int):
    if not halo:
        return y
    return tree_map(lambda t: t[halo:t.shape[0] - halo], y)


def _gather(outs: list, device) -> Any:
    """The devices' outputs concatenated along dim 0 on `device`."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {k: _gather([o[k] for o in outs], device) for k in outs[0]}
    if isinstance(outs[0], (list, tuple)):
        return type(outs[0])(_gather([o[i] for o in outs], device)
                             for i in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs], dim=0)


def _run_on_devices(prog: "ModuleProgram", slot: Slot, replicas: list,
                    args: list):
    """The program on every device of the slot, each on its own stream,
    over its part of each input; the outputs gathered on the first."""
    k = len(slot.run_devices)
    halo = prog.halo if k > 1 else 0
    pspecs = prog.input_pspecs or (None,) * len(args)
    parts = [_parts(torch.as_tensor(a), _split_dim(ps), k, halo)
             for a, ps in zip(args, pspecs)]
    outs = []
    for i, (dev, stream) in enumerate(zip(slot.run_devices, slot.streams)):
        with on_device(dev, stream):
            local = [p[i].to(dev) for p in parts]
            outs.append(_crop(prog.fn(replicas[i], *local), halo))
    if k > 1:
        _sync(slot)     # every part done before the first device reads it
    with on_slot(slot):
        out = _gather(outs, slot.device)
    _sync(slot)
    return out


class AccelModule:
    """A named accelerator with implementation alternatives."""

    def __init__(self, name: str, builder: Callable, footprints: list[int],
                 weights_key: int = 0):
        self.name = name
        self.builder = builder
        self.footprints = list(footprints)
        self._programs: dict[tuple, ModuleProgram] = {}
        self._host_weights: dict[int, Any] = {}
        self._compile_count = 0
        self._compile_keys: set[tuple] = set()
        self.weights_key = weights_key

    # -- decoupled compilation -------------------------------------------------

    def program(self, slot: Slot, footprint: int) -> ModuleProgram:
        key = (slot.congruence_key, footprint)
        if key not in self._programs:
            self._programs[key] = self.builder(slot, footprint)
        return self._programs[key]

    def host_weights(self, footprint: int):
        if footprint not in self._host_weights:
            prog = next(iter(self._programs.values()), None)
            assert prog is not None, "compile before requesting weights"
            if prog.init_weights is None:
                self._host_weights[footprint] = None
            else:
                self._host_weights[footprint] = prog.init_weights(
                    torch.Generator().manual_seed(self.weights_key))
        return self._host_weights[footprint]

    def place(self, slot: Slot, footprint: int) -> Placement:
        """Build (cache-mediated), upload a weight replica to each of the
        slot's devices and warm the program up on each once."""
        t0 = time.perf_counter()
        prog = self.program(slot, footprint)
        t1 = time.perf_counter()
        # congruence-class cache bookkeeping: a repeat build of the same
        # (program, congruence) is a relocation, not a fresh compile
        ckey = (slot.congruence_key, footprint)
        cache_hit = ckey in self._compile_keys
        self._compile_keys.add(ckey)
        self._compile_count += 1
        hw = self.host_weights(footprint)
        # weight upload = partial reconfiguration
        t2 = time.perf_counter()
        replicas = []
        for dev, stream in zip(slot.run_devices, slot.streams):
            with on_device(dev, stream):
                replicas.append(tree_map(lambda t: torch.as_tensor(t).to(dev),
                                         hw))
        _sync(slot)
        t3 = time.perf_counter()
        # the warm-up call on every device: kernels and library handles
        # load here
        _run_on_devices(prog, slot, replicas,
                        [s.zeros("cpu") for s in prog.abstract_inputs])
        t4 = time.perf_counter()
        return Placement(self, footprint, slot, prog.fn, replicas[0],
                         load_time_s=t3 - t2,
                         compile_time_s=(t1 - t0) + (t4 - t3),
                         cache_hit=cache_hit, replicas=replicas)


def run_placement(placement: Placement, *chunk_args):
    """Generic runner: invoke a resident module on concrete inputs; the
    outputs lie on the slot's first device, every stream of the slot
    synchronised.  A slot of several devices runs split (see above)."""
    slot = placement.slot
    if len(slot.run_devices) > 1:
        prog = placement.module.program(slot, placement.footprint)
        return _run_on_devices(prog, slot, placement.replicas,
                               list(chunk_args))
    with on_slot(slot):
        args = [_to_slot(a, slot) for a in chunk_args]
        out = placement.executable(placement.weights_on_slot, *args)
        _sync(slot)
    return out
