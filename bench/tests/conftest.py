"""The benchmark's tests: run from the root of the checkout with
``python -m pytest bench/tests`` (tests/ does not collect them).  Tests
marked ``gpu`` need a CUDA card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
