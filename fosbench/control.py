"""The readings that a cell's limits are set from, on the card.

    python3 fosbench/control.py --workload <cell> --seeds 11,12,... \
        --control 3 --seconds 1

For each seed, in one process: a short run of the cell at its own sizes
and load (`--seconds` of window, whole batches), then the
comparison of the program's outputs with the reference (the lower
readings), and for the first `--control` seeds the same comparison with
the reference computed in the precision below the configuration's in the
program's place (the control: TF32 for a float32 model with TF32 off;
the upper readings).  One JSON line a seed on
standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from fosbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    common.setup_paths()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = common.cell(args.workload)
    cfg = common.config(cell["config"])
    tr = common.traffic(cell["traffic"])
    kind = common.limits(cell["name"])["control"]
    runner = importlib.import_module(f"fosbench.{tr['kind']}")
    device = torch.device("cuda", 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = runner.run(cell, cfg, tr, seed, args.seconds, False, device,
                         t0, log=lambda *a, **k: None)
        line = {"seed": seed, "program": out["check"](),
                "attempted": out["attempted"], "failed": out["failed"]}
        if n < args.control:
            line["control"] = out["check"](kind)
            line["control_kind"] = kind
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
