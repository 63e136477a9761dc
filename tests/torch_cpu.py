"""torch for the port's CPU tests, with one core share of threads.

    from torch_cpu import torch

Every `tests/test_torch_*.py` takes torch from here.  It skips the
importing module where torch is not installed, and sets torch's
intra-op threads once for the process: the cores this process may run
on, shared among the pytest-xdist workers (`PYTEST_XDIST_WORKER_COUNT`,
1 outside xdist), and at least one.  Every worker imports every test
module while it collects, so the setting holds before the first test of
any file runs.  Left at torch's default, each of n workers starts a
thread for every core, and a train step's many small ops spin on n
times too few cores; one thread a worker runs them many times faster.
Under a single pytest process the tests keep every core.  Spawned rank
processes (`torch_ranks.py`) run one thread each, as each is one of
several on the same cores.
"""
from __future__ import annotations

import os

import pytest

torch = pytest.importorskip("torch")


def threads() -> int:
    """This process's share of the cores it may run on."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


torch.set_num_threads(threads())
