"""Process-local metrics registry: counters, gauges, timing histograms.

Stdlib copy of trlx_tpu.telemetry.registry, cut to what the serving
slice emits: labeled keys (``name{k=v}``), counters, last-value gauges
and span-duration histograms whose FIRST observation is kept apart (on
the serve path the first step carries the kernel build), plus the
structured ``summary()`` the JSON ``/metrics`` route returns.
"""

import threading
from collections import deque
from typing import Dict, Iterable, Mapping, Optional


def label_key(name: str, labels: Optional[Mapping[str, object]]) -> str:
    """Flatten ``name`` + labels into ``name{k=v,...}`` (keys sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class TimingHist:
    """Duration accumulator for one named phase (seconds)."""

    __slots__ = ("window", "count", "total", "max", "first", "last")

    def __init__(self, window: int = 512):
        self.window = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.first: Optional[float] = None
        self.last = 0.0

    def observe(self, seconds: float) -> None:
        seconds = float(seconds)
        if self.first is None:
            self.first = seconds
        else:
            # the steady-state window excludes the first call
            self.window.append(seconds)
        self.count += 1
        self.total += seconds
        self.last = seconds
        self.max = max(self.max, seconds)

    def quantile(self, q: float) -> float:
        if not self.window:
            return self.first or 0.0
        ordered = sorted(self.window)
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def stats(self) -> Dict[str, float]:
        out = {
            "count": self.count,
            "total_s": self.total,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "max_s": self.max,
            "last_s": self.last,
        }
        if self.first is not None:
            out["first_s"] = self.first
        return out


class MetricsRegistry:
    def __init__(self):
        # RLock like the reference: updates may nest (a span observing
        # while a caller holds the registry)
        self._lock = threading.RLock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, TimingHist] = {}

    def inc(self, name: str, n: float = 1.0,
            labels: Optional[Mapping[str, object]] = None) -> float:
        key = label_key(name, labels)
        with self._lock:
            value = self.counters.get(key, 0.0) + n
            self.counters[key] = value
        return value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Mapping[str, object]] = None) -> None:
        key = label_key(name, labels)
        with self._lock:
            self.gauges[key] = float(value)

    def observe(self, name: str, seconds: float,
                labels: Optional[Mapping[str, object]] = None) -> None:
        key = label_key(name, labels)
        with self._lock:
            hist = self.hists.get(key)
            if hist is None:
                hist = self.hists[key] = TimingHist()
            hist.observe(seconds)

    def predeclare(self, names: Iterable[str]) -> None:
        """Register counters at 0 without bumping existing values."""
        with self._lock:
            for name in names:
                self.counters.setdefault(name, 0.0)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": {n: h.stats() for n, h in self.hists.items()},
            }
