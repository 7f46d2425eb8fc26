"""Process-local metrics registry: counters, gauges, timing histograms
(stdlib copy of trlx_tpu.telemetry.registry).

- **counters** are monotonic event tallies (``fault/skipped_steps``,
  ``checkpoint/saves``): ``inc`` only;
- **gauges** are last-value-wins samples (``device/hbm_in_use_gb``,
  ``compile/ppo_update_first_s``);
- **timing histograms** accumulate span durations per phase name
  (``time/rollout``) with p50/p95/max over a bounded window, and keep
  the FIRST observation apart: on the card the first call of a phase
  carries the kernel build, the CUDA-graph capture and the allocator's
  warm-up, so ``first`` against the steady-state p50 is the first-call
  signal.

Plain dict and deque work, no torch and no host sync: safe from any hot
path. Updates take a reentrant lock, since the registry is written from
the scheduler worker, HTTP handler threads, the watchdog AND signal
handlers (PreemptionGuard increments ``fault/preempt_sigterm`` from
SIGTERM on the main thread, possibly interrupting that thread's own
``inc``). Two export shapes: ``tracker_stats()`` is the flat float dict
the tracker protocol carries per iteration; ``summary()`` is the
structured run-level record ``telemetry.json`` persists.

Every update takes optional ``labels``; a labeled series is stored under
the flattened key ``name{k=v,...}`` (keys sorted) in the same dicts, and
the Prometheus renderer splits it back (:func:`split_label_key`).
"""

import threading
from collections import deque
from typing import Dict, Iterable, Mapping, Optional, Tuple

#: fixed log-spaced latency bucket upper bounds (seconds) for the
#: cumulative Prometheus ``_bucket`` rendering, 1 ms to 300 s; anything
#: beyond lands only in ``+Inf`` (== count)
BUCKET_BOUNDS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def label_key(name: str, labels: Optional[Mapping[str, object]]) -> str:
    """Flatten ``name`` + labels into ``name{k=v,...}`` (keys sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def split_label_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`label_key`: ``name{k=v,...}`` -> (name, dict).
    Plain keys come back with an empty label dict."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    base, _, inner = key[:-1].partition("{")
    labels: Dict[str, str] = {}
    for part in inner.split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return base, labels


class TimingHist:
    """Duration accumulator for one named phase (seconds)."""

    __slots__ = ("window", "count", "total", "max", "first", "last",
                 "buckets")

    def __init__(self, window: int = 512):
        self.window = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.first: Optional[float] = None
        self.last = 0.0
        # per-bound observation counts (NON-cumulative; the renderer
        # accumulates them); unlike the window they include the first
        # observation
        self.buckets = [0] * len(BUCKET_BOUNDS)

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
        if seconds > self.max:
            self.max = seconds
        for i, bound in enumerate(BUCKET_BOUNDS):
            if seconds <= bound:
                self.buckets[i] += 1
                break

    def cumulative_buckets(self) -> Tuple[Tuple[float, int], ...]:
        """(upper_bound, cumulative_count) pairs, Prometheus ``le``
        semantics; ``+Inf`` is ``self.count`` and the renderer adds it."""
        out = []
        running = 0
        for bound, n in zip(BUCKET_BOUNDS, self.buckets):
            running += n
            out.append((bound, running))
        return tuple(out)

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
            # first-call signal, once the window holds two steady calls
            if len(self.window) >= 2 and out["p50_s"] > 0:
                out["first_over_p50"] = self.first / out["p50_s"]
        return out


class MetricsRegistry:
    def __init__(self):
        # RLock, not Lock: inc() runs inside signal handlers that can
        # interrupt the main thread mid-inc
        self._lock = threading.RLock()
        self.counters: Dict[str, float] = {}  # guarded-by: _lock
        self.gauges: Dict[str, float] = {}  # guarded-by: _lock
        self.hists: Dict[str, TimingHist] = {}  # guarded-by: _lock

    # -- updates -------------------------------------------------------- #

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

    # -- exports -------------------------------------------------------- #

    def tracker_stats(self) -> Dict[str, float]:
        """One flat float dict, the per-iteration emission: counters and
        gauges at their current value, each histogram at its LAST
        duration (the per-iteration ``time/<phase>``; run-level
        quantiles belong to :meth:`summary`)."""
        with self._lock:
            out = dict(self.counters)
            out.update(self.gauges)
            for name, hist in self.hists.items():
                out[name] = hist.last
        return out

    def summary(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": {n: h.stats() for n, h in self.hists.items()},
            }
