"""Build the native track-store library with the system compiler.

Plain C ABI + ctypes, no binding library: ``python -m
tpu3d_torch.native.build`` (or the first use through ``tpu3d_torch.native``)
compiles trackstore.cpp with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/tpu3d_torch/_trackstore.so`` at the repository root, never beside
the source, and again whenever the source is newer than the library.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "trackstore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu3d_torch"
OUT = BUILD_DIR / "_trackstore.so"


def build(verbose: bool = True) -> Path:
    """Compile into a temporary file and rename it into place, so that a
    process loading the library never sees half of one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"_trackstore.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=not verbose)
    os.replace(tmp, OUT)
    return OUT


def ensure_built() -> Optional[Path]:
    """Build if missing or stale; the library's path, or None where it
    cannot be built (no compiler)."""
    try:
        if not OUT.exists() or OUT.stat().st_mtime < SRC.stat().st_mtime:
            build(verbose=False)
        return OUT
    except (OSError, subprocess.CalledProcessError):
        return None


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
