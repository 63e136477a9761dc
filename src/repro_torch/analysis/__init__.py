"""The port's analysis package: the scheduler's runtime sanitizer.

`sanitizer.py` is the reference's `repro/analysis/sanitizer.py` renamed
into this package (`REPRO_SANITIZE=1` turns it on, as there); the policy
core (`core/scheduler.py`, `core/fabric.py`) imports it.  The static
checkers (schedlint) wait for ROADMAP A15.
"""
