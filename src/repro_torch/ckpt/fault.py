"""Fault tolerance: watchdog, fault injection, restart-from-checkpoint.

At 1000+-node scale the failure model is: a host stops making progress
(hardware fault, preemption, network partition) or stalls (straggler).
The training driver wraps its step loop with:

  - Heartbeat/Watchdog: detects a stalled step and raises in the driver
    (on a real cluster this triggers the coordinator's re-mesh path);
  - FaultInjector: deterministic fault injection for tests/drills;
  - run_with_restarts: supervisor that restarts the loop from the latest
    checkpoint, optionally on a *smaller* slot allocation (elastic shrink
    = FOS withdrawing a PR region).

A copy of `repro/ckpt/fault.py` (stdlib only), held to it by the AST copy
check in `tests/test_torch_core.py`.
"""
from __future__ import annotations

import threading
import time
from typing import Callable


class StepTimeout(RuntimeError):
    pass


class InjectedFault(RuntimeError):
    pass


class Watchdog:
    """Raises (via callback) if no heartbeat arrives within `timeout_s`.

    Straggler mitigation at dry-run scale: the driver treats a timeout
    like a failed worker — re-checkpoint boundary restart, possibly with
    the slow pod dropped from the mesh.
    """

    def __init__(self, timeout_s: float, on_timeout: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self):
        self._last = time.monotonic()
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def _watch(self):
        while not self._stop.wait(self.timeout_s / 4):
            if time.monotonic() - self._last > self.timeout_s:
                self._fired = True
                self.on_timeout()
                return

    @property
    def fired(self) -> bool:
        return self._fired


class FaultInjector:
    """Deterministic fault injection: fail at a given step (once)."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step
        self._done = False

    def check(self, step: int):
        if (self.fail_at_step is not None and not self._done
                and step == self.fail_at_step):
            self._done = True
            raise InjectedFault(f"injected fault at step {step}")


def run_with_restarts(run_fn: Callable[[int], int], *, max_restarts: int = 3,
                      log=print) -> tuple[int, int]:
    """Supervise run_fn(start_step) -> final_step, restarting on faults.

    Returns (final_step, n_restarts).  run_fn is responsible for restoring
    from its checkpoint manager at start_step.
    """
    restarts = 0
    step = 0
    while True:
        try:
            step = run_fn(step)
            return step, restarts
        except (InjectedFault, StepTimeout) as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            log(f"[fault] {e}; restart #{restarts} from latest checkpoint")
