"""Lightweight span tracer: named host-side phases as Chrome-trace events
(copy of trlx_tpu.telemetry.tracer).

``torch.profiler`` ($TRLX_TPU_PROFILE_DIR, trlx_tpu_torch.utils.profiling)
captures a full device trace: heavyweight and usually off. This tracer
is the always-cheap complement: every ``span(name)`` records one
complete event (``ph: "X"``, microsecond ``ts`` / ``dur``) into a
bounded in-memory buffer, exported as one JSON object per line (JSONL)
that Perfetto opens directly; for chrome://tracing wrap the lines in
``[...]``. The first occurrence of each name is flagged
(``args.first_call``): on the card it holds the kernel build, the
CUDA-graph capture and the allocator's warm-up.

Durations are HOST wall-clock between span entry and exit. CUDA launches
are asynchronous, so a span around a launch measures the enqueue; the
device time lands in whichever later span first waits for the result.
The learn loops therefore close each phase they time after its results
reach the host (``ppo_update`` and ``ilql_update`` after a device sync,
``rollout`` and ``eval`` after their tokens come back).

Every span also feeds the registry: a ``time/<name>`` observation, and a
``compile/<name>_first_s`` gauge on the first call.
"""

import contextlib
import json
import os
import time
from typing import Optional

from trlx_tpu_torch.telemetry.registry import MetricsRegistry


class SpanTracer:
    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        max_events: int = 100_000,
        clock=time.perf_counter,
    ):
        self.registry = registry
        self.max_events = max_events
        self.clock = clock
        self.t0 = clock()
        # anchor for externally-timestamped spans (add_span), which come
        # from time.monotonic (the supervisor's containment clock)
        self.t0_monotonic = time.monotonic()
        self.events = []
        self.dropped = 0
        self._seen = set()
        self._named_tracks = set()

    @contextlib.contextmanager
    def span(self, name: str):
        start = self.clock()
        try:
            yield
        finally:
            end = self.clock()
            dur = end - start
            first = name not in self._seen
            self._seen.add(name)
            if len(self.events) < self.max_events:
                event = {
                    "name": name,
                    "ph": "X",
                    "ts": round((start - self.t0) * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                    "pid": os.getpid(),
                    "tid": 0,
                }
                if first:
                    event["args"] = {"first_call": True}
                self.events.append(event)
            else:
                self.dropped += 1
            if self.registry is not None:
                self.registry.observe(f"time/{name}", dur)
                if first:
                    self.registry.set_gauge(f"compile/{name}_first_s", dur)
                if self.dropped == 1:
                    self.registry.inc("telemetry/trace_events_dropped")

    def add_span(self, name: str, start_mono: float, end_mono: float,
                 tid: int = 0, args=None) -> None:
        """Append one complete event whose timestamps come from
        ``time.monotonic`` rather than a live ``span()``; one Perfetto
        track per ``tid``. Bounded by the same ``max_events``."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            if self.registry is not None and self.dropped == 1:
                self.registry.inc("telemetry/trace_events_dropped")
            return
        event = {
            "name": name,
            "ph": "X",
            "ts": round((start_mono - self.t0_monotonic) * 1e6, 3),
            "dur": round(max(end_mono - start_mono, 0.0) * 1e6, 3),
            "pid": os.getpid(),
            "tid": int(tid),
        }
        if args:
            event["args"] = dict(args)
        self.events.append(event)

    def name_track(self, tid: int, label: str) -> None:
        """Label one tid with a Chrome-trace ``thread_name`` metadata
        event (once per tid)."""
        if tid in self._named_tracks or len(self.events) >= self.max_events:
            return
        self._named_tracks.add(tid)
        self.events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": os.getpid(),
            "tid": int(tid),
            "args": {"name": label},
        })

    def write_jsonl(self, path: str,
                    max_bytes: int = 64 * 1024 * 1024) -> str:
        """One Chrome-trace event per line, written atomically. When the
        buffer overflowed, or the lines exceed ``max_bytes`` (the OLDEST
        are dropped first), a dropped-events marker closes the file, so
        a truncated trace never reads as a complete one."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        lines = [json.dumps(event) + "\n" for event in self.events]
        dropped = self.dropped
        total = sum(len(line) for line in lines)
        at = 0
        while at < len(lines) - 1 and total > max_bytes:
            total -= len(lines[at])
            at += 1
            dropped += 1
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.writelines(lines[at:])
            if dropped:
                f.write(json.dumps({
                    "name": f"[{dropped} events dropped]",
                    "ph": "X",
                    "ts": round((self.clock() - self.t0) * 1e6, 3),
                    "dur": 0,
                    "pid": os.getpid(),
                    "tid": 0,
                }) + "\n")
        os.replace(tmp, path)
        return path
