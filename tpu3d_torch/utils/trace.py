"""Lightweight tracing (tpu3d/utils/trace.py): nested span timers on the
wall clock, optionally synchronized with the card, counters, and a
Chrome-trace JSON export (chrome://tracing or Perfetto). For kernel-level
profiles the CLI's ``--xprof DIR`` runs torch.profiler around the command."""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional

import torch


class Tracer:
    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._t0 = time.time()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, **meta):
        """Time a region. sync=True waits for the card's queued work before
        and after, so the span measures device time, not enqueue time."""
        if sync:
            _device_sync()
        start = time.time()
        try:
            yield self
        finally:
            if sync:
                _device_sync()
            end = time.time()
            with self._lock:
                self._events.append({
                    "name": name, "ph": "X", "pid": 0, "tid": threading.get_ident() % 1000,
                    "ts": (start - self._t0) * 1e6, "dur": (end - start) * 1e6,
                    "args": meta,
                })

    def count(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def summary(self) -> Dict[str, Any]:
        agg: Dict[str, List[float]] = {}
        for e in self._events:
            agg.setdefault(e["name"], []).append(e["dur"] / 1e6)
        return {
            "spans": {
                k: {"count": len(v), "total_s": round(sum(v), 3),
                    "mean_s": round(sum(v) / len(v), 4)}
                for k, v in sorted(agg.items())
            },
            "counters": dict(self._counters),
        }

    def export_chrome_trace(self, path: str):
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)


def _device_sync():
    """Wait for the card when CUDA has been initialised; a no-op on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


_GLOBAL: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Tracer()
    return _GLOBAL


@contextlib.contextmanager
def trace_span(name: str, sync: bool = False, **meta):
    with get_tracer().span(name, sync=sync, **meta):
        yield
