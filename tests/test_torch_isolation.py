"""The port stands alone: importing it pulls in neither jax nor the
reference package, and its entry points never fall back to the CPU."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from torch_cpu import torch  # noqa: E402

from repro_torch.core import Shell, uniform_shell  # noqa: E402
from repro_torch.launch.serve import DaemonServeRun, ServeRun, serve, \
    serve_daemon  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import TrainRun, train  # noqa: E402

_IMPORT_ALL = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(len(names), bad, " ".join(names))
"""


def test_importing_the_port_loads_no_jax_or_reference():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(" ", 1)
    bad, names = rest.split("] ", 1)
    assert int(n) >= 15, out.stdout      # every module was imported
    assert bad.strip() == "[", out.stdout
    # the runtime is in the walk: policy core, device layer, sanitizer,
    # flight recorder; and the MoE layer
    for name in ("repro_torch.core.daemon", "repro_torch.core.zoo",
                 "repro_torch.core.scheduler", "repro_torch.analysis.sanitizer",
                 "repro_torch.obs.recorder", "repro_torch.obs.export",
                 "repro_torch.models.moe",
                 "repro_torch.configs.jamba_v0_1_52b",
                 # the training stack and schedlint
                 "repro_torch.optim.adamw", "repro_torch.optim.grad_compress",
                 "repro_torch.data.pipeline", "repro_torch.ckpt.checkpoint",
                 "repro_torch.ckpt.fault", "repro_torch.launch.steps",
                 "repro_torch.launch.train", "repro_torch.analysis.walker",
                 "repro_torch.analysis.__main__",
                 # distribution
                 "repro_torch.sharding.partition",
                 "repro_torch.sharding.pipeline_parallel",
                 "repro_torch.launch.mesh", "repro_torch.configs.common",
                 # the dry run and the roofline
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.roofline_model",
                 "repro_torch.sharding.op_analysis",
                 "repro_torch.launch.dryrun_table",
                 # the examples
                 "repro_torch.examples.quickstart",
                 "repro_torch.examples.elastic_train",
                 "repro_torch.examples.multi_tenant_serving",
                 "repro_torch.examples.fos_registry_tour"):
        assert name in names.split(), names


_IMPORT_DRYRUN = """
import os, sys
env, hook = dict(os.environ), sys.excepthook
import torch
from repro_torch.launch import dryrun, roofline_model
from repro_torch.sharding import op_analysis
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad, torch.distributed.is_initialized(), torch.cuda.is_initialized(),
      dict(os.environ) == env, sys.excepthook is hook)
"""


def test_importing_the_dry_run_touches_no_cuda_group_or_environment():
    """The dry run, the roofline and the op accounting import neither jax
    nor the reference, and importing them starts no CUDA, joins no process
    group, sets no environment variable (the reference's dry run sets
    XLA_FLAGS at import) and leaves the excepthook alone."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _IMPORT_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False", "False", "True", "True"], \
        out.stdout


def test_serve_without_cuda_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(ServeRun(), log=lambda _: None)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")


def test_shell_without_cuda_raises_instead_of_binding_the_cpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="devices="):
        Shell(uniform_shell("host1_s1", (1, 1), 1))


def test_serve_daemon_without_cuda_raises_instead_of_using_the_cpu():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_daemon(DaemonServeRun(), log=lambda _: None)


def test_train_without_cuda_raises_instead_of_using_the_cpu():
    _no_cuda()
    assert TrainRun().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(TrainRun(), log=lambda _: None)


def test_init_train_state_without_cuda_raises_instead_of_using_the_cpu():
    _no_cuda()
    from repro_torch import configs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.init_train_state(configs.get("llama3.2-3b", reduced=True),
                               torch.Generator().manual_seed(0))


def test_init_distributed_without_cuda_raises_instead_of_using_gloo():
    """The process-group helper defaults to CUDA (NCCL) and does not fall
    back to the CPU: no group is made."""
    _no_cuda()
    import torch.distributed as dist
    from repro_torch.launch import mesh
    initialized = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_distributed()
    assert dist.is_initialized() == initialized


def test_train_under_a_mesh_without_cuda_raises_before_any_group():
    """train() builds its mesh over the world's ranks; without CUDA the
    default device raises before a process group exists."""
    _no_cuda()
    import torch.distributed as dist
    initialized = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(TrainRun(elastic_switch_step=2, steps=4), log=lambda _: None)
    assert dist.is_initialized() == initialized
