"""Run one cell of the benchmark and print its result line.

    python3 fosbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root, on a machine with the cards the cell asks for.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, the device's busy and window seconds
and a breakdown.  The numbers that decide `correct` are printed beside
their limits as the last lines on standard error and under `checks`, the
line's last key.  The line is the last of standard output.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)     # the package, not its folder's files

from fosbench import common  # noqa: E402


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def result_line(cell: dict, out: dict, trace: bool, limits: dict,
                device_kind: str) -> dict:
    """The result line of a run of a mix: the metrics of the run's kind,
    the device, the breakdown of a traced run, and `correct` from the
    comparison (run here, once the window has closed) against the cell's
    limits, which comes last as `checks`."""
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}}
    if trace:
        for m in common.metrics_of(cell["name"], "per_layer"):
            v = common.reader(m["name"])(out["ctx"])
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in common.metrics_of(cell["name"], "end_to_end"):
            result["metrics"][m["name"]] = {"value": out["e2e"][m["name"]],
                                            "unit": m["unit"]}
    result["device"] = {"platform": "gpu", "kind": device_kind,
                        "count": cell["chips"],
                        "memory_peak_bytes": out["memory_peak_bytes"]}
    prof = out["ctx"].get("profile")
    if trace and prof:
        if prof.get("busy_s"):
            result["device"]["busy_s"] = prof["busy_s"]
            result["device"]["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
        else:
            err(f"fosbench: profile not read: {prof.get('why')}")
    out["compared"] = got = out["check"]()
    checks = {k: {"value": got[k], "limit": v["limit"]}
              for k, v in limits["checks"].items()}
    result["correct"] = (all(c["value"] <= c["limit"]
                             for c in checks.values())
                         and out["failed"] == 0)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.setup_paths()
    cell = common.cell(args.workload)
    cfg = common.config(cell["config"])
    tr = common.traffic(cell["traffic"])
    limits = common.limits(cell["name"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        err(f"fosbench: {cell['name']} needs {cell['chips']} CUDA "
            f"device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    runner = importlib.import_module(f"fosbench.{tr['kind']}")
    out = runner.run(cell, cfg, tr, args.seed, args.seconds,
                     bool(args.trace), device, T_START, log=print)
    found = common.forbidden_modules()
    if found:
        err(f"fosbench: the process holds {found} (JAX or the JAX package)")
        return 4
    result = result_line(cell, out, bool(args.trace), limits,
                         torch.cuda.get_device_name(0))
    err(f"fosbench: card {card_line()}; compared "
        f"{json.dumps(out['compared'])}")
    for k, c in result["checks"].items():
        err(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
