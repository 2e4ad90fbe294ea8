"""The checkout's root on the path, so ``pytest portbench/tests`` finds
the ``portbench`` package from any working directory."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
