"""Logical hardware abstraction: JSON registry of shells and modules.

Mirrors the paper's section 4.2: shells and accelerators are described by
minimal JSON records; the runtime and 'generic runners' (the daemon's invoke
path) work from these descriptors alone, so shells and modules can be
swapped without touching any other component.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any

from repro_torch.core.shell import ShellSpec


@dataclasses.dataclass(frozen=True)
class ImplAlt:
    """One implementation alternative (paper: bitstreams of varying size).

    Recognised `meta` keys: `true_chunk_ms` (simulator: actual service
    time when the estimate is deliberately wrong), `ckpt_save_ms` /
    `ckpt_restore_ms` (per-implementation context save/restore cost
    overriding `PolicyConfig.ckpt_save_ms`/`ckpt_restore_ms` — a
    state-heavy accelerator checkpoints slower than a stateless one).
    """
    name: str
    footprint: int                 # slots occupied (power of two)
    est_chunk_ms: float = 0.0      # scheduler cost model; refined online
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self):
        return {"name": self.name, "footprint": self.footprint,
                "est_chunk_ms": self.est_chunk_ms, "meta": self.meta}

    @staticmethod
    def from_json(d):
        return ImplAlt(d["name"], d["footprint"],
                       d.get("est_chunk_ms", 0.0), d.get("meta", {}))


@dataclasses.dataclass(frozen=True)
class ModuleDescriptor:
    """Paper Listing 2: accelerator descriptor.

    `entrypoint` is an importable "pkg.mod:fn" returning a ModuleBuilder —
    the analogue of the bitstream file reference.  `registers` (the ADR-map
    analogue) is the module's abstract I/O signature, auto-filled at first
    compile, which the daemon's generic runner uses to invoke any module
    without module-specific host code.
    """
    name: str
    entrypoint: str
    impls: tuple[ImplAlt, ...]
    kind: str = "fn"               # fn | decode | prefill | train
    registers: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self):
        return {"name": self.name, "entrypoint": self.entrypoint,
                "kind": self.kind,
                "impls": [i.to_json() for i in self.impls],
                "registers": self.registers, "meta": self.meta}

    @staticmethod
    def from_json(d):
        return ModuleDescriptor(
            d["name"], d["entrypoint"],
            tuple(ImplAlt.from_json(i) for i in d["impls"]),
            d.get("kind", "fn"), d.get("registers", {}), d.get("meta", {}))

    def impl_for(self, footprint: int) -> ImplAlt | None:
        for i in self.impls:
            if i.footprint == footprint:
                return i
        return None

    @property
    def footprints(self) -> list[int]:
        return sorted(i.footprint for i in self.impls)

    def load_builder(self):
        mod, _, fn = self.entrypoint.partition(":")
        return getattr(importlib.import_module(mod), fn)


def parse_transfer_pair(key, shells) -> tuple[str, str]:
    """Validate a cross-shell transfer key — a `"victim->thief"` string
    or a `(victim, thief)` tuple over `shells` — and return the pair.
    Shared by `Registry.register_fabric` and `Fabric.__init__` so both
    surfaces parse and reject identically."""
    pair = tuple(key.split("->")) if isinstance(key, str) else tuple(key)
    if len(pair) != 2 or any(s not in shells for s in pair):
        raise ValueError(
            f"transfer pair {key!r} must name two of the fabric's "
            f"shells {sorted(shells)} as '<victim>-><thief>'")
    return pair


@dataclasses.dataclass(frozen=True)
class FabricDescriptor:
    """A registered fabric: an ordered list of shell names scheduled as
    one unit (core/fabric.py).  Like shells and modules, a fabric is a
    serialisable descriptor (fabrics.json), so the scale-out topology is
    swappable without touching any other component.

    `transfer_ms` maps `"victim->thief"` shell pairs to the modeled
    cross-shell payload-movement cost per stolen chunk, overriding the
    fabric-wide `PolicyConfig.transfer_ms` default for that direction
    (e.g. boards on different hosts cost more than same-host shells).

    `network` optionally describes a link-level interconnect topology
    (core/network.py JSON schema: switches, ports, default_link,
    links) replacing the scalar model wholesale; it is mutually
    exclusive with `transfer_ms`.  Both are validated *here*, at
    construction/`from_json` time, with an error naming the offending
    pair or topology entry — a malformed descriptor must fail at load,
    not later at steal time.
    """
    name: str
    shells: tuple[str, ...]
    transfer_ms: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    network: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for pair in self.transfer_ms:
            # descriptors must stay JSON-serialisable: tuple keys would
            # register fine but crash every later save()
            if not isinstance(pair, str):
                raise ValueError(
                    f"fabric {self.name!r}: descriptor transfer_ms "
                    f"keys must be '<victim>-><thief>' strings, got "
                    f"{pair!r}")
            parse_transfer_pair(pair, self.shells)
        if self.network:
            if self.transfer_ms:
                raise ValueError(
                    f"fabric {self.name!r}: 'network' topology and "
                    f"per-pair 'transfer_ms' are mutually exclusive — "
                    f"the topology already prices every shell pair")
            from repro_torch.core.network import validate_topology
            try:
                validate_topology(self.network, self.shells)
            except ValueError as e:
                raise ValueError(
                    f"fabric {self.name!r}: invalid network "
                    f"topology: {e}") from e

    def to_json(self):
        d = {"name": self.name, "shells": list(self.shells),
             "transfer_ms": self.transfer_ms, "meta": self.meta}
        if self.network:
            d["network"] = self.network
        return d

    @staticmethod
    def from_json(d):
        return FabricDescriptor(d["name"], tuple(d["shells"]),
                                d.get("transfer_ms", {}),
                                d.get("meta", {}),
                                d.get("network", {}))


class Registry:
    """Central JSON-backed registry (paper: 'JSON based registry')."""

    def __init__(self):
        self.shells: dict[str, ShellSpec] = {}
        self.modules: dict[str, ModuleDescriptor] = {}
        self.fabrics: dict[str, FabricDescriptor] = {}

    # -- registration --------------------------------------------------------

    def register_shell(self, spec: ShellSpec) -> None:
        self.shells[spec.name] = spec

    def register_module(self, desc: ModuleDescriptor) -> None:
        self.modules[desc.name] = desc

    def register_fabric(self, desc: FabricDescriptor) -> None:
        # transfer pairs and the network topology were already validated
        # at descriptor construction (FabricDescriptor.__post_init__);
        # the registry only adds the shell-existence check
        for s in desc.shells:
            self.shell(s)              # fail fast on unknown shell names
        self.fabrics[desc.name] = desc

    def module(self, name: str) -> ModuleDescriptor:
        if name not in self.modules:
            raise KeyError(f"unknown module {name!r}; "
                           f"registered: {sorted(self.modules)}")
        return self.modules[name]

    def shell(self, name: str) -> ShellSpec:
        if name not in self.shells:
            raise KeyError(f"unknown shell {name!r}; "
                           f"registered: {sorted(self.shells)}")
        return self.shells[name]

    def fabric(self, name: str) -> FabricDescriptor:
        if name not in self.fabrics:
            raise KeyError(f"unknown fabric {name!r}; "
                           f"registered: {sorted(self.fabrics)}")
        return self.fabrics[name]

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "shells.json").write_text(json.dumps(
            {k: v.to_json() for k, v in self.shells.items()}, indent=2))
        (path / "modules.json").write_text(json.dumps(
            {k: v.to_json() for k, v in self.modules.items()}, indent=2))
        (path / "fabrics.json").write_text(json.dumps(
            {k: v.to_json() for k, v in self.fabrics.items()}, indent=2))

    @staticmethod
    def load(path: str | Path) -> "Registry":
        path = Path(path)
        reg = Registry()
        shells = json.loads((path / "shells.json").read_text())
        modules = json.loads((path / "modules.json").read_text())
        for v in shells.values():
            reg.register_shell(ShellSpec.from_json(v))
        for v in modules.values():
            reg.register_module(ModuleDescriptor.from_json(v))
        fabrics_path = path / "fabrics.json"   # absent in pre-fabric saves
        if fabrics_path.exists():
            for v in json.loads(fabrics_path.read_text()).values():
                reg.register_fabric(FabricDescriptor.from_json(v))
        return reg
