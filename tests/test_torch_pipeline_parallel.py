"""The port's GPipe schedule against sequential layers and the reference's.

`gpipe_apply` runs on 4 spawned gloo ranks, a (pod=2, data=2) mesh
(`tests/torch_ranks.py`), for n_micro 2, 4 and 8, with the stage params
whole on every rank and as DTensors split over "pod"; the reference's
`gpipe_apply` runs the same inputs on a (2, 2) mesh of 4 host devices in
a subprocess (its own test, `tests/test_pipeline_parallel.py`, is green).
Every rank's output is held to the sequential layers and to the
reference's at 1e-5.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_cpu import torch  # noqa: E402

import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_MICRO = [2, 4, 8]
L, D, B = 4, 16, 8

_JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.sharding.pipeline_parallel import gpipe_apply, split_stages

work = sys.argv[1]
f = np.load(os.path.join(work, "gpipe.npz"))
w, b, x = (jnp.asarray(f[k]) for k in ("w", "b", "x"))
mesh = jax.make_mesh((2, 2), ("pod", "data"))

def stage_fn(params, h):
    ws, bs = params
    for i in range(ws.shape[0]):
        h = jnp.tanh(h @ ws[i] + bs[i])
    return h

out = {}
for n_micro in (2, 4, 8):
    with jax.set_mesh(mesh):
        out[str(n_micro)] = np.asarray(jax.jit(lambda p, xx: gpipe_apply(
            stage_fn, p, xx, mesh=mesh, axis="pod",
            n_micro=n_micro))(split_stages((w, b), 2), x))
np.savez(os.path.join(work, "ref_gpipe.npz"), **out)
print("PIPELINE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("gpipe")
    rng = np.random.default_rng(0)
    inp = {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
           "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
           "x": rng.standard_normal((B, D)).astype(np.float32)}
    torch_ranks.save_tree(work / "gpipe.npz", inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_CODE, str(work)],
                         env=env, capture_output=True, text=True,
                         timeout=torch_ranks.TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-1500:] + out.stderr[-2500:]
    with np.load(work / "ref_gpipe.npz") as f:
        ref = dict(f)
    seq = inp["x"]
    for i in range(L):
        seq = np.tanh(seq @ inp["w"][i] + inp["b"][i])
    return torch_ranks.run("gpipe", 4, work), ref, seq


@pytest.mark.parametrize("params", ["whole", "split"])
@pytest.mark.parametrize("n_micro", N_MICRO)
def test_gpipe_matches_sequential(n_micro, params, runs):
    ranks, _, seq = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"{params}_{n_micro}"].numpy(), seq,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("params", ["whole", "split"])
@pytest.mark.parametrize("n_micro", N_MICRO)
def test_gpipe_matches_reference(n_micro, params, runs):
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"{params}_{n_micro}"].numpy(),
                                   ref[str(n_micro)], atol=1e-5, rtol=1e-5)
