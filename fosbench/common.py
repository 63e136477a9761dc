"""What every part of the harness shares: the checkout's paths, the files
found by name, the statistics, and the guard against the JAX package.

The harness reads its cells from `BENCHMARK.json` and finds each cell's
configuration (`configs/<name>.json`), traffic mix (`traffic/<name>.json`),
limits (`limits/<cell>.json`) and per-layer readers (`metrics/<name>.py`)
by name, so a new cell is new files and entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "fosbench"

# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the port was made from (compared whole: `repro_torch`
# begins with `repro` and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def setup_paths() -> None:
    """The port's package on the path, and every cache of the program and
    its libraries in fixed directories inside the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in `modules` (default: sys.modules) that are JAX or
    the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def metrics_of(cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports: those with
    no `workloads` key and those that list the cell."""
    return [m for m in benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric_name: str):
    """The per-layer metric's reader, `metrics/<name>.py`'s `read`."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "fosbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def p95(xs) -> float:
    """Nearest-rank 95th percentile (the port's `core/simulator.py::p95`):
    the value at rank ceil(0.95 n)."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]
