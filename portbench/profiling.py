"""Readers of a torch.profiler trace, and the harness's own spans.

A traced run profiles a short steady sub-window of its window. Inside it the
harness marks what the host is doing with named ranges (``span``), which the
profiler records on the host's timeline beside the device's operations; the
sub-window itself is the range ``portbench.window``. Device operations are
the kernels, copies and fills the profiler saw on the card.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
SHORT_GAP_US = 20.0       # a gap shorter than this is one kernel waiting on the next
NAME_CHARS = 120


@contextlib.contextmanager
def span(name: str, on: bool):
    """A named range on the host's timeline when ``on`` (a traced
    sub-window), else nothing."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Stages:
    """Seconds of each named stage of a set-up, each ended by a
    synchronize of the card: ``with stages("name"): ...``."""

    def __init__(self, device):
        self.device, self.seconds = torch.device(device), {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


class Trace:
    """What one profile holds, in microseconds on the profiler's clock:
    ``ops`` the device operations (name, start, end) inside the sub-window,
    ``window`` its (start, end), ``spans`` the harness's ranges and the
    host's operator ranges (for naming idle gaps)."""

    def __init__(self, prof: "torch.profiler.profile"):
        from torch.autograd import DeviceType

        events = prof.events()
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        wins = [e for e in cpu if e.name == WINDOW]
        if not wins:
            raise RuntimeError("the profile holds no portbench.window range")
        w = wins[0].time_range
        self.window = (w.start, w.end)
        self.ops = [(e.name, max(e.time_range.start, w.start), min(e.time_range.end, w.end))
                    for e in events if _is_device(e)
                    and e.time_range.end > w.start and e.time_range.start < w.end]
        self.spans = sorted((e.name[len(SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                            for e in cpu if e.name.startswith(SPAN_PREFIX) and e.name != WINDOW)
        host = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                      if not e.name.startswith(SPAN_PREFIX)
                      and not getattr(e, "is_user_annotation", False))
        self._host_starts = [h[0] for h in host]
        self._host = host

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops])

    def device_us(self, pattern: Optional[str] = None) -> float:
        """Summed time of the device operations whose name contains
        ``pattern`` (all when None)."""
        return sum(e - s for n, s, e in self.ops if pattern is None or pattern in n)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            out[n[:NAME_CHARS]] += e - s
        return dict(out)

    def gaps(self) -> List[Tuple[float, float]]:
        """The sub-window's idle intervals: no device operation running."""
        out, t = [], self.window[0]
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def _host_op_at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self._host[max(0, i - 400):i]):
            if e >= t:
                return name
        return None

    def gap_name(self, s: float, e: float) -> str:
        """What the host was doing while the device was idle: the innermost
        harness span and host operator at the gap's midpoint."""
        if e - s < SHORT_GAP_US:
            return f"kernel_to_kernel (<{SHORT_GAP_US:g} us)"
        t = 0.5 * (s + e)
        spans = [n for n, a, b in self.spans if a <= t <= b]
        name = spans[-1] if spans else "window"
        op = self._host_op_at(t)
        return f"{name}/{op}" if op else name

    def idle_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e in self.gaps():
            out[self.gap_name(s, e)[:NAME_CHARS]] += e - s
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each as [name, seconds], longest first."""
        def rows(d):
            return [[n, v / 1e6] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rows(self.by_name()), "idle_gaps": rows(self.idle_by_name())}


def range_device_us(events, prefix: str) -> float:
    """Device time of the kernels launched by host operators that start
    inside a host range whose name begins with ``prefix`` (on the same
    thread), such as ``Optimizer.step#`` around an optimizer's step."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = defaultdict(list)
    for e in cpu:
        if e.name.startswith(prefix):
            ranges[e.thread].append((e.time_range.start, e.time_range.end))
    total = 0.0
    for e in cpu:
        if e.name.startswith(prefix) or not e.kernels:
            continue
        if any(a <= e.time_range.start <= b for a, b in ranges.get(e.thread, ())):
            total += sum(k.duration for k in e.kernels)
    return total


def profiler():
    """A profiler of the host and the card, recording no shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def synchronizer(device):
    """A function that waits for the card (nothing on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class SubWindow:
    """A traced run's profiled sub-window inside its measured window: it
    opens before the first unit of work (a chunk, a view) that starts
    ``start_s`` or more into the window, when ``on``, and closes after
    ``units`` units; ``trace`` then holds its :class:`Trace`."""

    def __init__(self, on: bool, start_s: float, units: int, device):
        self.on, self.start_s, self.units = on, start_s, units
        self.sync = synchronizer(device)
        self.prof, self.done, self.trace = None, 0, None

    @property
    def open(self) -> bool:
        return self.prof is not None

    def before(self, elapsed_s: float) -> None:
        """Called before each unit, with the seconds since the window opened."""
        if self.on and self.prof is None and self.done == 0 and elapsed_s >= self.start_s:
            self.sync()
            self.prof = profiler()
            self.prof.start()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()

    def after(self) -> None:
        """Called after each unit."""
        if self.prof is None:
            return
        self.done += 1
        if self.done == self.units:
            self.sync()
            self._range.__exit__(None, None, None)
            self.prof.stop()
            self.trace = Trace(self.prof)
            self.prof = None
