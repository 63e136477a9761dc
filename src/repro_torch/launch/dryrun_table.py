"""Per-rank counts of dry-run cells, one row each, on 256 fake ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_table \
        [--cells llama3.2-3b:train_4k,...] [--rules-override seq=none] \
        [--out rows.json]

Each cell runs once at full depth (`dryrun.run_cell(...,
cost_extrapolate=False)`, the (16, 16) mesh, CPU only) and its row has:
useful FLOPs (the model's 6N-style FLOPs, `roofline_model.model_flops`,
over the FLOPs rank 0 dispatches times the ranks), rank 0's argument and
temp GB, its collective operand and ring-wire bytes and the number of
each collective, and the attention
heads rank 0 computes with (the dry run's `attn_split`).
`--rules-override seq=none` maps the sequence to no mesh axis under
"train": the step without sequence parallelism.  The default cells are
llama3.2-3b's train_4k and the six train_4k cells whose args + temp
passed 80 GB a rank before attention split by heads.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch.configs.common import apply_cell_policy
from repro_torch.launch import dryrun, roofline_model
from repro_torch.models.api import SHAPE_CELLS

CELLS = ["llama3.2-3b:train_4k", "granite-3-8b:train_4k", "yi-9b:train_4k",
         "qwen3-14b:train_4k", "qwen3-moe-30b-a3b:train_4k",
         "phi3.5-moe-42b-a6.6b:train_4k", "jamba-v0.1-52b:train_4k"]
GB = 1e9


def cell_row(arch: str, cell_name: str, rule_overrides=None) -> dict:
    res = dryrun.run_cell(arch, cell_name, multi_pod=False,
                          cost_extrapolate=False,
                          rule_overrides=rule_overrides)
    full = res["full"]
    cell = SHAPE_CELLS[cell_name]
    cfg = apply_cell_policy(configs.get(arch), cell)
    flops = full["cost"]["flops"]
    mem = full["memory"]
    return {
        "arch": arch, "cell": cell_name,
        "useful_flops": roofline_model.model_flops(cfg, cell)
        / (flops * res["chips"]),
        "flops_per_rank": flops,
        "args_gb": mem["argument_size_in_bytes"] / GB,
        "temp_gb": mem["temp_size_in_bytes"] / GB,
        "coll_gb": full["coll"]["total"] / GB,
        "coll_wire_gb": full["coll"]["wire_total"] / GB,
        "coll_counts": full["coll"]["counts"],
        "attn_split": res.get("attn_split"),
        "trace_s": full["trace_s"]}


def _override(text: str) -> dict:
    out = {}
    for item in filter(None, text.split(",")):
        k, v = item.split("=")
        out[k] = None if v.lower() == "none" else v
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--rules-override", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rows = []
    for item in args.cells.split(","):
        arch, cell = item.split(":")
        row = cell_row(arch, cell, _override(args.rules_override) or None)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
