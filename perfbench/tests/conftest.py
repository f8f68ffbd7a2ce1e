"""The benchmark's own tests, on the CPU at small sizes: they import the
harness (``perfbench/``) and the program (``src/``) by path."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
