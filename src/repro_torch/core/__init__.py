"""FOS core in PyTorch: a copy of `repro.core` for one or more CUDA devices.

The policy modules are the reference's, renamed into this package
(tests/test_torch_core.py holds them to it); shell, module, bus and zoo
bind the policy to torch devices and streams.

- shell.py      shell/slot geometry (PR-region analogue)
- allocator.py  buddy allocation with adjacent-slot merging
- registry.py   JSON logical-hardware abstraction (shells + modules)
- module.py     decoupled build + warm-up, relocation, weight upload
- bus.py        layout adaptors (bus virtualisation analogue)
- scheduler.py  resource-elastic space-time policy (replicate/replace/reuse)
- arrivals.py   online arrival-rate estimation (predictive reservation)
- slo.py        per-tenant QoS contracts + predictive admission control
- checkpoint.py context save/restore for preempted chunks (priced, migratable)
- fabric.py     one scheduling contract over many shells (locality + stealing)
- simulator.py  discrete-event execution of the policy (tests + Fig 15)
- daemon.py     live multi-tenant execution service (a Fabric executor)
- zoo.py        module builders (mandelbrot/sobel/matmul/LM)
"""
from repro_torch.core.allocator import BuddyAllocator, Range
from repro_torch.core.arrivals import ArrivalEstimator
from repro_torch.core.checkpoint import CheckpointManager, ChunkCheckpoint
from repro_torch.core.daemon import Daemon, JobHandle
from repro_torch.core.fabric import Fabric, FabricJob
from repro_torch.core.network import FabricNetwork, Link, Transfer
from repro_torch.core.registry import FabricDescriptor, ImplAlt, \
    ModuleDescriptor, Registry
from repro_torch.core.scheduler import Assignment, CostModel, PolicyConfig, \
    Request, SchedulerState
from repro_torch.core.shell import Shell, ShellSpec, SlotSpec, uniform_shell
from repro_torch.core.simulator import SimJob, SimResult, simulate
from repro_torch.core.slo import ADMIT, AdmissionController, \
    AdmissionRejected, AdmissionVerdict, DEGRADE, QoSContract, REJECT


def default_registry() -> Registry:
    """Registry preloaded with the benchmark accelerator zoo."""
    reg = Registry()
    from repro_torch.core.shell import production_shells
    for spec in production_shells().values():
        reg.register_shell(spec)
    reg.register_module(ModuleDescriptor(
        name="mandelbrot", entrypoint="repro_torch.core.zoo:build_mandelbrot",
        impls=(ImplAlt("x1", 1, 12.0), ImplAlt("x2", 2, 6.5),
               ImplAlt("x4", 4, 3.6)), kind="fn"))
    reg.register_module(ModuleDescriptor(
        name="sobel", entrypoint="repro_torch.core.zoo:build_sobel",
        impls=(ImplAlt("x1", 1, 6.0), ImplAlt("x2", 2, 3.4)), kind="fn"))
    reg.register_module(ModuleDescriptor(
        name="matmul", entrypoint="repro_torch.core.zoo:build_matmul",
        impls=(ImplAlt("x1", 1, 4.0), ImplAlt("x2", 2, 2.3)), kind="fn"))
    # lm-forward carries large activation state: its context save/restore
    # is priced above the policy default (ImplAlt.meta overrides)
    reg.register_module(ModuleDescriptor(
        name="lm-forward", entrypoint="repro_torch.core.zoo:build_lm_forward",
        impls=(ImplAlt("x1", 1, 20.0,
                       meta={"ckpt_save_ms": 2.0, "ckpt_restore_ms": 2.0}),
               ImplAlt("x2", 2, 11.0,
                       meta={"ckpt_save_ms": 2.0, "ckpt_restore_ms": 2.0})),
        kind="fn"))
    # example multi-shell fabrics (Fabric.from_registry(reg, name))
    reg.register_fabric(FabricDescriptor("pod512", ("pod256_s4",
                                                    "pod256_s8")))
    reg.register_fabric(FabricDescriptor("hostpair", ("host8_s4",
                                                      "host4_s4")))
    # mixed board generations: a reference-clock shell next to a
    # half-clock one, with a modeled 2 ms cross-host payload transfer
    # per stolen chunk in either direction
    reg.register_fabric(FabricDescriptor(
        "hostpair_hetero", ("host8_s4", "host8_s4_lowclk"),
        transfer_ms={"host8_s4->host8_s4_lowclk": 2.0,
                     "host8_s4_lowclk->host8_s4": 2.0}))
    return reg
