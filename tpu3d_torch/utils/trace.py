"""Lightweight tracing (tpu3d/utils/trace.py): nested span timers on the
wall clock, optionally synchronized with the card, counters, and a
Chrome-trace JSON export (chrome://tracing or Perfetto). For kernel-level
profiles the CLI's ``--xprof DIR`` runs torch.profiler around the command.

Beyond tpu3d's spans, the dense path marks its layers with two kinds that
cost next to nothing while no one listens:

- ``hot_span(name, **meta)``: a host span, recorded in the global tracer
  with an id and its parent's id (the innermost hot span open on the same
  thread) only while tracing is on: after :func:`enable` (the CLI's
  ``--trace``) or while a torch.profiler profile records. Under the
  profiler it is also the range ``tpu3d.<name>`` on the profiler's own
  timeline, beside the card's operations. Off, it is one flag check.
  ``launch_span(name)`` is the same around a kernel launch of the port's
  own, with an operator's range, so that the profiler links the kernel to it.
- ``device_span(name)``: the card's time for the work it encloses on the
  current stream, from a pair of timing events, never synchronizing. Inside
  a CUDA-graph capture under :func:`graph_marks` it always records: the
  pair becomes two event-record nodes that every replay re-records, and the
  capturing code reads them after a replay (:meth:`Tracer.read_marks`).
  Eagerly it records only while tracing is on, and the pair is read at a
  later hot-span boundary, or by :meth:`Tracer.spans` / :meth:`Tracer.summary`,
  once it has completed.

A device span's event sits on its own lane (``pid`` 1) at the host time its
work was enqueued (for graph marks: the replay's enqueue plus the mark's
offset from the replay's start on the card), with the card's duration.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PROFILER_PREFIX = "tpu3d."

_ENABLED = False
_LOCAL = threading.local()      # per thread: the open hot spans' ids, a capture's marks
_NULL = contextlib.nullcontext()


class SpanRef(NamedTuple):
    """What ``with hot_span(...) as ref`` binds while tracing is on: the
    span's id and its start on the host's clock (``time.time()``)."""
    id: int
    start: float


class Tracer:
    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._ids = itertools.count(1)
        self._pending: collections.deque = collections.deque()   # eager device pairs

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

    @contextlib.contextmanager
    def _hot(self, name: str, meta: Dict[str, Any], op_range: bool = False):
        """A hot span recorded now (what :func:`hot_span` and, with
        ``op_range``, :func:`launch_span` return while tracing is on)."""
        self.read_device()
        stack = _stack()
        ref = SpanRef(next(self._ids), time.time())
        parent = stack[-1] if stack else None
        stack.append(ref.id)
        if not _autograd_profiler._is_profiler_enabled:
            ranged = _NULL
        elif op_range:
            ranged = torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + name)
        else:
            ranged = torch.profiler.record_function(PROFILER_PREFIX + name)
        try:
            with ranged:
                yield ref
        finally:
            end = time.time()
            stack.pop()
            with self._lock:
                self._events.append({
                    "name": name, "ph": "X", "pid": 0, "tid": threading.get_ident() % 1000,
                    "ts": (ref.start - self._t0) * 1e6, "dur": (end - ref.start) * 1e6,
                    "args": meta, "id": ref.id, "parent": parent,
                })
            self.read_device()

    @contextlib.contextmanager
    def _device(self, name: str):
        """An eager device span recorded now (what :func:`device_span`
        returns while tracing is on and nothing captures); binds its start
        event."""
        stack = _stack()
        parent, host = (stack[-1] if stack else None), time.time()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield start
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._pending.append((name, start, end, parent, host))

    def _device_event(self, name: str, ms: float, parent: Optional[int],
                      host: float) -> Dict[str, Any]:
        return {"name": name, "ph": "X", "cat": "device", "pid": 1, "tid": 0,
                "ts": (host - self._t0) * 1e6, "dur": ms * 1e3, "args": {},
                "id": next(self._ids), "parent": parent}

    def read_device(self) -> None:
        """Record the eager device pairs that have completed, in the order
        they were enqueued (never waits for the card)."""
        with self._lock:
            while self._pending and self._pending[0][2].query():
                name, start, end, parent, host = self._pending.popleft()
                self._events.append(self._device_event(name, start.elapsed_time(end), parent,
                                                       host))

    def read_marks(self, marks, parent: SpanRef, origin: "torch.cuda.Event") -> bool:
        """Record one replay's graph marks (``graph_marks``' (name, start,
        end) pairs) as device spans under the hot span ``parent``, placed
        from ``origin``, an event recorded just before the replay, if they
        have completed. Returns whether they had; never waits."""
        if not marks[-1][2].query():
            return False
        events = [self._device_event(name, s.elapsed_time(e), parent.id,
                                     parent.start + origin.elapsed_time(s) / 1e3)
                  for name, s, e in marks]
        with self._lock:
            self._events.extend(events)
        return True

    def spans(self) -> List[Dict[str, Any]]:
        """The hot and device spans recorded so far (their Chrome-trace
        events: ``name``, ``ts`` and ``dur`` in microseconds, ``args``,
        ``id``, ``parent``, and ``cat`` "device" on device spans), after
        reading the device pairs that have completed."""
        self.read_device()
        with self._lock:
            return [dict(e) for e in self._events if "id" in e]

    def count(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def summary(self) -> Dict[str, Any]:
        self.read_device()
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
        self.read_device()
        with open(path, "w") as f:
            json.dump({"traceEvents": self._events}, f)


def _device_sync():
    """Wait for the card when CUDA has been initialised; a no-op on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stack() -> List[int]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


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


def enable(on: bool = True) -> bool:
    """Turn the global tracer's hot and device spans on (or off, outside a
    profile); returns the previous setting."""
    global _ENABLED
    was, _ENABLED = _ENABLED, bool(on)
    return was


def tracing() -> bool:
    """Whether hot and eager device spans record: after :func:`enable`, or
    while a torch.profiler profile records."""
    return _ENABLED or _autograd_profiler._is_profiler_enabled


def hot_span(name: str, **meta):
    """A span on the hot path, in the global tracer: a shared no-op context
    while tracing is off, else one recorded in it (binds a :class:`SpanRef`)."""
    if not (_ENABLED or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return get_tracer()._hot(name, meta)


def launch_span(name: str):
    """A hot span around a kernel launched outside any torch operator (a
    call into the port's CUDA library). Under the profiler its range
    ``tpu3d.<name>`` is an operator's record, not a user annotation: the
    profiler links a kernel to the innermost operator open at its launch,
    never to an annotation, so the kernel is attributed to this range as a
    torch operator's kernels are to the operator."""
    if not (_ENABLED or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return get_tracer()._hot(name, {}, op_range=True)


def device_span(name: str):
    """The card's time for the enclosed work on the current stream (a no-op
    on the CPU): under a capture inside :func:`graph_marks`, a pair of
    event-record nodes; eagerly, while tracing is on, a pair read later
    (binds its start event); else nothing."""
    if not torch.cuda.is_initialized():
        return _NULL
    if torch.cuda.is_current_stream_capturing():
        marks = getattr(_LOCAL, "marks", None)
        return _NULL if marks is None else _graph_mark(name, marks)
    if not tracing():
        return _NULL
    return get_tracer()._device(name)


@contextlib.contextmanager
def _graph_mark(name: str, marks: list):
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    yield
    end.record()
    marks.append((name, start, end))


def thread_context() -> tuple:
    """This thread's open hot spans and a capture's marks list, for work that
    another thread runs on its behalf: the autograd engine runs a CUDA
    backward on a thread of its own, so a device span there needs the
    forward's context (:func:`adopt`)."""
    return list(_stack()), getattr(_LOCAL, "marks", None)


@contextlib.contextmanager
def adopt(context: tuple):
    """Run the enclosed block with another thread's :func:`thread_context`:
    its device spans nest under that thread's hot spans and, inside a
    capture, record into its marks."""
    prev = getattr(_LOCAL, "stack", None), getattr(_LOCAL, "marks", None)
    _LOCAL.stack, _LOCAL.marks = list(context[0]), context[1]
    try:
        yield
    finally:
        _LOCAL.stack, _LOCAL.marks = prev


@contextlib.contextmanager
def graph_marks():
    """Collect, as a list of (name, start, end) event pairs, the device
    spans that a CUDA-graph capture on this thread records."""
    prev, marks = getattr(_LOCAL, "marks", None), []
    _LOCAL.marks = marks
    try:
        yield marks
    finally:
        _LOCAL.marks = prev
