"""The benchmark's CPU tests import ``portbench`` and the program from the
checkout's root."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
