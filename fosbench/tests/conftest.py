"""The benchmark's tests: `python -m pytest fosbench/tests` from the
checkout's root.  Tests that need a card carry the `card` marker and skip
inside the test where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
