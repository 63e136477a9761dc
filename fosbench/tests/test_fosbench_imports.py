"""Nothing the benchmark imports is JAX or the JAX package `repro`
(top-level names compared whole: `repro_torch` is the port)."""
import json
import subprocess
import sys
from pathlib import Path

from fosbench import common

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path[0:0] = [{root!r}, {src!r}]
from fosbench import common
common.setup_paths()
import fosbench.run, fosbench.serve, fosbench.reference
import fosbench.control, fosbench.tracing
for m in common.benchmark()["per_layer"]:
    common.reader(m["name"])
import repro_torch.launch.serve, repro_torch.core, repro_torch.core.zoo
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_benchmark_process():
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in tops and "fosbench" in tops
    assert not set(tops) & set(common.FORBIDDEN)


def test_names_are_compared_whole():
    assert common.forbidden_modules(["repro_torch.models", "fosbench"]) == []
    assert common.forbidden_modules(["repro.models.api"]) == ["repro"]
    assert common.forbidden_modules(["jax.numpy", "jaxlib"]) == ["jax",
                                                                 "jaxlib"]


def test_every_metric_and_cell_has_its_files():
    bench = common.benchmark()
    for m in bench["per_layer"]:
        assert (ROOT / "fosbench" / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        common.config(w["config"]), common.traffic(w["traffic"])
        lim = common.limits(w["name"])
        assert lim["checks"] and lim["control"]
