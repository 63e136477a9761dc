"""CLI: `python -m repro_torch.analysis [paths...]`.

With no arguments, checks the incremental scheduling core
(src/repro/core/*.py) plus the observability package
(src/repro/obs/*.py — its tracer/recorder are declared sim modules
in-file and must stay as deterministic as the fabric feeding them).
Prints one line per finding and exits 1 if any survive the
pragmas/allowlist, 0 on a clean run — cheap enough (pure stdlib, no
jax, <1s) to gate CI and pre-commit on.
"""
from __future__ import annotations

import sys
from pathlib import Path

from repro_torch.analysis import analyze

CORE = Path(__file__).resolve().parents[1] / "core"
OBS = Path(__file__).resolve().parents[1] / "obs"


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = [p for p in argv if not p.startswith("-")]
    if not paths:
        paths = sorted(str(p) for d in (CORE, OBS)
                       for p in d.glob("*.py")
                       if p.name != "__init__.py")
    findings = analyze(paths)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"schedlint: {n} finding{'s' if n != 1 else ''} "
          f"across {len(paths)} file{'s' if len(paths) != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
