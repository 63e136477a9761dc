"""The port stands alone: importing it pulls in neither jax nor the
reference package, and its entry points never fall back to the CPU."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import ServeRun, serve  # noqa: E402

_IMPORT_ALL = """
import pkgutil, importlib, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax_or_reference():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15, out.stdout      # every module was imported
    assert bad.strip() == "[]", out.stdout


def test_serve_without_cuda_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(ServeRun(), log=lambda _: None)
