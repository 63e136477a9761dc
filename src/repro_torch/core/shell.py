"""FOS shell: the static partition of the compute fabric.

Mirrors `repro/core/shell.py`.  The *shell* is the host-side runtime plus
a geometry descriptor that splits a grid of devices into homogeneous,
adjacent, mergeable *slots* (the PR-region analogue).  Slots with equal
shapes are congruent: a module built against one slot's interface runs
on any congruent slot (module relocation), and adjacent slots in the same
adjacency group combine to host bigger implementation alternatives
(PR-region merging).

One NVIDIA GPU is one device.  A slot binds the devices of its rectangle
and owns one CUDA stream on each, so that distinct slots run concurrently.
A module placed on a slot of several devices holds one weight replica on
each and runs data-parallel over them (`core/module.py`), the reference's
slot mesh: a `DeviceMesh` cannot span GPUs that one process drives, and
the daemon is one process.  A CPU shell's entries (`[cpu] * n`) are n
logical devices, so the same split runs on the CPU.  The specs,
`uniform_shell`, `production_shells` and the merge geometry are the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """One reconfigurable region: a rectangle of the device grid."""
    name: str
    origin: tuple[int, int]        # (row, col) in the shell device grid
    shape: tuple[int, int]         # (rows, cols)
    group: str = "g0"              # adjacency group (mergeable within)

    def to_json(self) -> dict:
        return {"name": self.name, "origin": list(self.origin),
                "shape": list(self.shape), "group": self.group}

    @staticmethod
    def from_json(d: dict) -> "SlotSpec":
        return SlotSpec(d["name"], tuple(d["origin"]), tuple(d["shape"]),
                        d.get("group", "g0"))


@dataclasses.dataclass(frozen=True)
class ShellSpec:
    """Logical shell description (the paper's shell JSON, Listing 1).

    `speed` is the shell's relative clock (1.0 = the reference board):
    a chunk estimated at `est_chunk_ms` on the reference takes
    `est_chunk_ms / speed` here.  It feeds the fabric's heterogeneity-
    aware placement and the simulator's true chunk times.

    `ckpt` declares context-save/restore support (the PR-region
    readback capability checkpointing needs, core/checkpoint.py):
    a `ckpt=False` shell evicts lossily even when the fabric policy
    checkpoints, and checkpointed chunks never migrate onto it.
    """
    name: str
    grid: tuple[int, int]          # device grid (rows, cols)
    axes: tuple[str, str] = ("data", "model")
    slots: tuple[SlotSpec, ...] = ()
    version: str = "1"
    speed: float = 1.0             # relative clock (1.0 = reference)
    ckpt: bool = True              # context save/restore supported

    def to_json(self) -> dict:
        return {"name": self.name, "grid": list(self.grid),
                "axes": list(self.axes), "version": self.version,
                "speed": self.speed, "ckpt": self.ckpt,
                "regions": [s.to_json() for s in self.slots]}

    @staticmethod
    def from_json(d: dict) -> "ShellSpec":
        return ShellSpec(
            d["name"], tuple(d["grid"]), tuple(d.get("axes",
                                                     ("data", "model"))),
            tuple(SlotSpec.from_json(s) for s in d["regions"]),
            d.get("version", "1"), d.get("speed", 1.0),
            d.get("ckpt", True))

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def slot_shape(self) -> tuple[int, int]:
        shapes = {s.shape for s in self.slots}
        assert len(shapes) == 1, "slots must be homogeneous"
        # schedlint: ok(determinism) singleton set (asserted above):
        # there is no order to depend on
        return next(iter(shapes))

    def coverage(self) -> float:
        """Fraction of the grid covered by slots (Table-1 analogue)."""
        covered = sum(s.shape[0] * s.shape[1] for s in self.slots)
        return covered / (self.grid[0] * self.grid[1])

    def validate(self) -> None:
        grid = np.zeros(self.grid, dtype=int)
        for s in self.slots:
            r, c = s.origin
            h, w = s.shape
            assert r + h <= self.grid[0] and c + w <= self.grid[1], s
            grid[r:r + h, c:c + w] += 1
        assert (grid <= 1).all(), "slots overlap"


def uniform_shell(name: str, grid: tuple[int, int], n_slots: int,
                  axis: int = 1, speed: float = 1.0,
                  ckpt: bool = True) -> ShellSpec:
    """Split the grid into n homogeneous adjacent slots along `axis`."""
    assert grid[axis] % n_slots == 0
    slots = []
    for i in range(n_slots):
        if axis == 1:
            origin = (0, i * (grid[1] // n_slots))
            shape = (grid[0], grid[1] // n_slots)
        else:
            origin = (i * (grid[0] // n_slots), 0)
            shape = (grid[0] // n_slots, grid[1])
        slots.append(SlotSpec(f"slot{i}", origin, shape))
    spec = ShellSpec(name, grid, slots=tuple(slots), speed=speed,
                     ckpt=ckpt)
    spec.validate()
    return spec


# Pre-built shells (the paper ships ZCU102 / UltraZed / Ultra-96 shells),
# the reference's geometries.
def production_shells() -> dict[str, ShellSpec]:
    return {
        # a 16x16 grid, 4 slots of 64 devices
        "pod256_s4": uniform_shell("pod256_s4", (16, 16), 4),
        # the same grid, 8 slots of 32 (finer-grained multi-tenancy)
        "pod256_s8": uniform_shell("pod256_s8", (16, 16), 8),
        # small "edge" shells for CPU-host execution benchmarks
        "host8_s4": uniform_shell("host8_s4", (1, 8), 4),
        "host8_s2": uniform_shell("host8_s2", (1, 8), 2),
        "host4_s4": uniform_shell("host4_s4", (1, 4), 4),
        # a previous-generation board at half the reference clock, for
        # heterogeneous fabrics (mixed board generations / edge+cloud)
        "host8_s4_lowclk": uniform_shell("host8_s4_lowclk", (1, 8), 4,
                                         speed=0.5),
    }


class Slot:
    """A slot bound to concrete devices: its rectangle of the shell's
    device grid, every entry of it as a device to run on (`run_devices`,
    row-major), one CUDA stream on each (None for a CPU entry), and the
    first device, where outputs are gathered."""

    def __init__(self, spec: SlotSpec, devices: np.ndarray,
                 axes: tuple[str, str]):
        self.spec = spec
        self.devices = devices                 # [rows, cols] device array
        self.axes = axes
        self.run_devices: list[torch.device] = list(devices.flat)
        self.device: torch.device = self.run_devices[0]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.run_devices]
        self.stream = self.streams[0]

    @property
    def congruence_key(self) -> tuple:
        """Executables relocate freely between slots with equal keys."""
        return (self.spec.shape, self.axes)

    def __repr__(self):
        return f"Slot({self.spec.name}, shape={self.spec.shape})"


class Shell:
    """ShellSpec bound to a real device grid ("loading the shell").

    `devices=None` binds every CUDA device of the machine and raises if
    there is none: a shell never falls back to the CPU by itself.  Tests
    pass `devices=[torch.device("cpu")] * n`."""

    def __init__(self, spec: ShellSpec, devices=None):
        spec.validate()
        self.spec = spec
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"Shell({spec.name!r}): CUDA is not available; pass "
                    f"devices=[torch.device('cpu')] * n to bind the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        n = spec.grid[0] * spec.grid[1]
        assert len(devices) >= n, (len(devices), n)
        self.grid = np.array(devices[:n], dtype=object).reshape(spec.grid)
        self.slots = [
            Slot(s, self.grid[s.origin[0]:s.origin[0] + s.shape[0],
                              s.origin[1]:s.origin[1] + s.shape[1]],
                 spec.axes)
            for s in spec.slots
        ]

    def merged_slot(self, indices: list[int]) -> Slot:
        """Combine adjacent slots (same group, contiguous) into one."""
        specs = [self.spec.slots[i] for i in indices]
        assert len({s.group for s in specs}) == 1, "cross-group merge"
        specs = sorted(specs, key=lambda s: s.origin)
        rows = specs[0].shape[0]
        assert all(s.shape[0] == rows and s.origin[0] == specs[0].origin[0]
                   for s in specs), "merge only along the column axis"
        for a, b in zip(specs, specs[1:]):
            assert a.origin[1] + a.shape[1] == b.origin[1], \
                f"slots not adjacent: {a} {b}"
        origin = specs[0].origin
        width = sum(s.shape[1] for s in specs)
        merged = SlotSpec("+".join(s.name for s in specs), origin,
                          (rows, width), specs[0].group)
        devs = self.grid[origin[0]:origin[0] + rows,
                         origin[1]:origin[1] + width]
        return Slot(merged, devs, self.spec.axes)
