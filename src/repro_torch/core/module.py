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
    weights_on_slot: Any
    load_time_s: float
    compile_time_s: float
    cache_hit: bool


@contextlib.contextmanager
def on_slot(slot: Slot):
    """Inference mode, the slot's device and its stream as the current
    ones, for this thread."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        if slot.stream is not None:
            stack.enter_context(torch.cuda.device(slot.device))
            stack.enter_context(torch.cuda.stream(slot.stream))
        yield


def _sync(slot: Slot) -> None:
    if slot.stream is not None:
        slot.stream.synchronize()


def _to_slot(x, slot: Slot):
    return torch.as_tensor(x).to(slot.device)


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
        """Build (cache-mediated), upload the weights onto the slot and
        warm the program up there once."""
        slot.require_one_device()
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
        with on_slot(slot):
            # weight upload = partial reconfiguration
            t2 = time.perf_counter()
            w_dev = tree_map(lambda t: _to_slot(t, slot), hw)
            _sync(slot)
            t3 = time.perf_counter()
            # the warm-up call: kernels and library handles load here
            prog.fn(w_dev, *(s.zeros(slot.device)
                             for s in prog.abstract_inputs))
            _sync(slot)
            t4 = time.perf_counter()
        return Placement(self, footprint, slot, prog.fn, w_dev,
                         load_time_s=t3 - t2,
                         compile_time_s=(t1 - t0) + (t4 - t3),
                         cache_hit=cache_hit)


def run_placement(placement: Placement, *chunk_args):
    """Generic runner: invoke a resident module on concrete inputs; the
    outputs lie on the slot's device, the slot's stream synchronised."""
    slot = placement.slot
    with on_slot(slot):
        args = [_to_slot(a, slot) for a in chunk_args]
        out = placement.executable(placement.weights_on_slot, *args)
        _sync(slot)
    return out
