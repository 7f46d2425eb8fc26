"""The device timeline of a traced part of the window, from
``torch.profiler`` (CUPTI on the card), reduced to what the per-layer
metrics read: the window's length, the union of the intervals in which a
kernel, copy or set ran on the device, the device time by kernel name,
and the idle gaps labelled with the benchmark span the host was in."""

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

class Timeline:
    """A reduced trace; times in seconds."""

    def __init__(self, window: Tuple[int, int], device: List[tuple],
                 spans: List[tuple]):
        self.window_ns = window
        lo, hi = window
        # device intervals clipped to the window: (name, start, end) ns
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.spans = spans  # (name, start, end) ns, host annotations
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_intervals = merged

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) / 1e9

    def time_of(self, match) -> float:
        """Device seconds of the intervals whose name ``match(name)``."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def idle_by_label(self) -> Dict[str, float]:
        """Idle device time inside the window, by the innermost benchmark
        span open on the host when each gap began ("none" outside
        them)."""
        lo, hi = self.window_ns
        gaps, at = [], lo
        for s, e in self.busy_intervals:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        spans = sorted(self.spans, key=lambda x: x[1])
        out: Dict[str, float] = {}
        for s, e in gaps:
            label, width = "none", None
            for name, a, b in spans:
                if a > s:
                    break
                if b >= s and (width is None or b - a < width):
                    label, width = name, b - a
            out[label] = out.get(label, 0.0) + (e - s) / 1e9
        return out

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        ops = sorted(self.by_name().items(), key=lambda x: -x[1])[:n]
        gaps = sorted(self.idle_by_label().items(), key=lambda x: -x[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _reduce(prof, window: Tuple[int, int],
            spans: List[tuple]) -> Optional[Timeline]:
    """The device events of ``prof``; ``window`` and ``spans`` are host
    times on the profiler's clock (wall-clock ns). Where the device
    events do not fall inside the host window, their own extent is the
    window."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            start = ev.start_ns()
            device.append((ev.name(), start, start + ev.duration_ns()))
    if not device:
        return Timeline(window, [], spans)
    inside = sum(1 for _, s, e in device if s >= window[0] and e <= window[1])
    if inside < len(device) / 2:
        window = (min(s for _, s, _ in device), max(e for _, _, e in device))
    return Timeline(window, device, spans)


class Tracer:
    """Traces the parts of a run that a driver marks with
    :meth:`capture` (device activity only: the host's side is the
    benchmark's own spans); off, every call is a no-op."""

    def __init__(self, on: bool):
        self.on = on
        self.active = False
        self.done = False
        self.spans: List[tuple] = []
        self._prof = self._window = self._timeline = None

    @property
    def timeline(self) -> Optional[Timeline]:
        """The traced part, reduced on first read (not on the thread that
        stopped the profiler: serving's scheduler would wait for it)."""
        if self._timeline is None and self._prof is not None:
            self._timeline = _reduce(self._prof, self._window, self.spans)
            self._prof = None
        return self._timeline

    @contextlib.contextmanager
    def capture(self):
        """Trace the body (once per run: the first capture is kept)."""
        started = self.start()
        try:
            yield
        finally:
            if started:
                self.stop()

    def start(self) -> bool:
        """Start tracing; False when off or already done. Call it, and
        :meth:`stop`, on the thread that launches the device work: the
        profiler's stop waited for ever on a CUDA-graph replay launched
        from another thread at that moment."""
        if not self.on or self.done or self.active:
            return False
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                             else [ProfilerActivity.CPU])
        self._prof.__enter__()
        self.active = True
        self._t0 = time.time_ns()
        return True

    def warm(self) -> None:
        """Start and stop a profiler once, so that a later start does
        not pay the first one's set-up inside the window."""
        from torch.profiler import ProfilerActivity, profile

        if torch.cuda.is_available():
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.cuda.synchronize()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window = (self._t0, time.time_ns())
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True

    @contextlib.contextmanager
    def label(self, name: str):
        """A host span the idle gaps are labelled by."""
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))
