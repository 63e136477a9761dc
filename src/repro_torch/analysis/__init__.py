"""schedlint: scheduler-invariant static analysis (pure stdlib).

Three AST-based checkers over the incremental scheduling core, plus a
runtime sanitizer companion (`sanitizer.py`, `REPRO_SANITIZE=1`):

  - **mutation** (mutation.py): every mutation of a tracked
    `SchedulerState` field (`scheduler.TRACKED_FIELDS`) must have a
    dominating `_touch()`/`_bump()` version bump on the same path;
  - **memo** (memo.py): every declared memo cache (`MEMO_CONTRACTS`)
    must key on every piece of versioned state its computation reads;
  - **determinism** (determinism.py): simulator-path modules must be
    free of wall-clock, randomness, `id()` ordering, `os.environ`
    reads and unordered-set iteration.

The contracts live *in the checked code* as plain literal constants
(`TRACKED_FIELDS`, `MEMO_CONTRACTS`, ...) and are extracted from the
AST — running the checkers imports nothing from `repro_torch.core`, so
`python -m repro_torch.analysis` works in seconds on a bare CPython with no
jax installed.  docs/static_analysis.md documents the invariants and
the allowlist policy.
"""
from __future__ import annotations

from repro_torch.analysis.walker import Finding, Project
from repro_torch.analysis.determinism import check_determinism
from repro_torch.analysis.memo import check_memo
from repro_torch.analysis.mutation import check_mutation

__all__ = ["Finding", "Project", "analyze", "check_determinism",
           "check_memo", "check_mutation"]


def analyze(paths, sim_modules=None) -> list[Finding]:
    """Run all three checkers over `paths`; findings sorted by file/line."""
    project = Project(paths, sim_modules=sim_modules)
    findings = (check_mutation(project) + check_memo(project)
                + check_determinism(project))
    return sorted(findings, key=lambda f: (f.file, f.line, f.checker))
