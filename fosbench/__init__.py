"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

Run one cell: `python3 fosbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (or `python -m fosbench ...`) from the
checkout's root.  See README.md.
"""
