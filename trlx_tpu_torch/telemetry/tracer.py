"""Lightweight span tracer: named host-side phases as Chrome-trace events
(copy of trlx_tpu.telemetry.tracer, on the profiler's clock).

``torch.profiler`` ($TRLX_TPU_PROFILE_DIR, trlx_tpu_torch.utils.profiling)
captures a full device trace: heavyweight and usually off. This tracer
is the always-cheap complement: every ``span(name)`` records one
complete event (``ph: "X"``, microsecond ``ts`` / ``dur``) into a
bounded in-memory buffer, exported as one JSON object per line (JSONL)
that Perfetto opens directly; for chrome://tracing wrap the lines in
``[...]``. The first occurrence of each name is flagged
(``args.first_call``): on the card it holds the kernel build, the
CUDA-graph capture and the allocator's warm-up. A span opened inside
another on the same thread names it (``args.parent``), so a reader can
take each span's self time.

One clock: ``ts`` counts from ``t0``, a reading of the tracer's clock
(``time.monotonic``, the serve path's ``supervisor.monotonic``), and
``anchor_ns`` is the Unix-epoch ns read beside it: the clock
``torch.profiler`` stamps its events on. :meth:`SpanTracer.epoch_ns`
puts any event, live or added from the serve path's stamps, on that
clock, and ``trace.jsonl`` opens with the anchor (a ``clock_anchor``
metadata event), so the program's trace and a profiler's Chrome trace
open on one timeline.

Durations are HOST wall-clock between span entry and exit. CUDA launches
are asynchronous, so a span around a launch measures the enqueue; the
device time lands in whichever later span first waits for the result.
The learn loops therefore close each phase they time after its results
reach the host (``ppo_update`` and ``ilql_update`` after a device sync,
``rollout`` and ``eval`` after their tokens come back). A device phase
(``span(..., device=True)``) adds, while a ``torch.profiler`` records
and only then, a ``record_function`` range and a pair of timing CUDA
events around its launches (the second at exit, or earlier at
``end_device()``, before a read that waits for the device); the pair
becomes ``args.device_ms`` once the device has passed the second event
(polled with ``query()`` as later device phases close, or by
:meth:`SpanTracer.resolve_device`: no synchronisation of its own). The
range, the events and the polling fall inside the device phase's own
span. A span the body ``drop()``-s records nothing.

Every span also feeds the registry: a ``time/<name>`` observation, and a
``compile/<name>_first_s`` gauge on the first call.
"""

import json
import os
import threading
import time
from typing import Optional, Tuple

from trlx_tpu_torch.telemetry.device import profiler_recording, timing_event
from trlx_tpu_torch.telemetry.registry import MetricsRegistry


class _Span:
    """One live span (the context manager :meth:`SpanTracer.span`
    returns); the body may add arguments with :meth:`set`."""

    __slots__ = ("tracer", "name", "args", "device", "start", "parent",
                 "mark", "end_mark", "range", "dropped")

    def __init__(self, tracer, name: str, args, device: bool):
        self.tracer, self.name, self.device = tracer, name, device
        self.args = dict(args) if args else None
        self.mark = self.end_mark = self.range = None
        self.dropped = False

    def set(self, **args) -> None:
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def end_device(self) -> None:
        """The device part of a device phase ends here: its end event is
        recorded now, not at exit. Called before a host read that waits
        for the device, so the wait's lag is not counted as device
        time."""
        if self.mark is not None and self.end_mark is None:
            self.end_mark = timing_event()

    def drop(self) -> None:
        """Record nothing for this span: the body found no work."""
        self.dropped = True

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = self.tracer.clock()
        if self.device and profiler_recording():
            from torch.autograd.profiler import record_function

            self.range = record_function(self.name)
            self.range.__enter__()
            self.mark = timing_event()
        return self

    def __exit__(self, *exc):
        # a device phase's range, events and polling fall inside its own
        # span, never in the enclosing span's own time
        marks = None
        if self.mark is not None and not self.dropped:
            marks = (self.mark, self.end_mark or timing_event())
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.device and self.tracer._pending:
            self.tracer.resolve_device()
        end = self.tracer.clock()
        self.tracer._stack().pop()
        if not self.dropped:
            self.tracer._record(self, end, marks)
        return False


class SpanTracer:
    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        max_events: int = 100_000,
        clock=time.monotonic,
    ):
        self.registry = registry
        self.max_events = max_events
        self.clock = clock
        self.t0 = clock()
        #: the profiler's clock (Unix-epoch ns) at ``t0``
        self.anchor_ns = time.time_ns()
        self.events = []
        self.dropped = 0
        self._seen = set()
        self._named_tracks = set()
        self._local = threading.local()  # each thread's open spans
        # device phases whose CUDA events the device has not passed yet:
        # (event, start mark, end mark)
        self._pending = []
        self._pending_lock = threading.Lock()

    # -- the clock ------------------------------------------------------- #

    def to_epoch_ns(self, t: float) -> int:
        """A reading of the tracer's clock on the profiler's clock."""
        return self.anchor_ns + round((t - self.t0) * 1e9)

    def epoch_ns(self, event) -> Tuple[int, int]:
        """(start, end) of a recorded event on the profiler's clock."""
        start = self.anchor_ns + round(event["ts"] * 1e3)
        return start, start + round(event["dur"] * 1e3)

    # -- spans ------------------------------------------------------------ #

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, args=None, device: bool = False) -> _Span:
        """A context manager timing one named phase; ``args`` land in the
        event's ``args``; ``device``: a device phase (module docstring)."""
        return _Span(self, name, args, device)

    def _record(self, span: _Span, end: float, marks) -> None:
        name, dur = span.name, end - span.start
        first = name not in self._seen
        self._seen.add(name)
        if len(self.events) < self.max_events:
            event = {
                "name": name,
                "ph": "X",
                "ts": round((span.start - self.t0) * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "pid": os.getpid(),
                "tid": 0,
            }
            args = dict(span.args) if span.args else {}
            if span.parent is not None:
                args["parent"] = span.parent
            if first:
                args["first_call"] = True
            if args:
                event["args"] = args
            self.events.append(event)
            if marks is not None and marks[1] is not None:
                event.setdefault("args", {})
                with self._pending_lock:
                    self._pending.append((event, *marks))
        else:
            self.dropped += 1
        if self.registry is not None:
            self.registry.observe(f"time/{name}", dur)
            if first:
                self.registry.set_gauge(f"compile/{name}_first_s", dur)
            if self.dropped == 1:
                self.registry.inc("telemetry/trace_events_dropped")

    def resolve_device(self) -> int:
        """Turn each device phase whose end event the device has passed
        into ``args.device_ms``; returns how many still wait. Polls
        (``query()``), never waits."""
        with self._pending_lock:
            waiting = []
            for event, start, end in self._pending:
                if end.query():
                    event["args"]["device_ms"] = start.elapsed_time(end)
                else:
                    waiting.append((event, start, end))
            self._pending = waiting
            return len(waiting)

    def add_span(self, name: str, start: float, end: float, tid: int = 0,
                 args=None) -> None:
        """Append one complete event whose timestamps are readings of the
        tracer's clock taken elsewhere (the serve path's
        ``supervisor.monotonic`` stamps) rather than a live ``span()``;
        one Perfetto track per ``tid``. Bounded by the same
        ``max_events``."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            if self.registry is not None and self.dropped == 1:
                self.registry.inc("telemetry/trace_events_dropped")
            return
        event = {
            "name": name,
            "ph": "X",
            "ts": round((start - self.t0) * 1e6, 3),
            "dur": round(max(end - start, 0.0) * 1e6, 3),
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
        """One Chrome-trace event per line, written atomically, after a
        first ``clock_anchor`` metadata line (``args.epoch_ns``: ``ts`` 0
        on the profiler's clock). When the buffer overflowed, or the
        lines exceed ``max_bytes`` (the OLDEST are dropped first), a
        dropped-events marker closes the file, so a truncated trace never
        reads as a complete one."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.resolve_device()
        anchor = json.dumps({
            "name": "clock_anchor",
            "ph": "M",
            "pid": os.getpid(),
            "tid": 0,
            "args": {"epoch_ns": self.anchor_ns},
        }) + "\n"
        lines = [json.dumps(event) + "\n" for event in self.events]
        dropped = self.dropped
        total = len(anchor) + sum(len(line) for line in lines)
        at = 0
        while at < len(lines) - 1 and total > max_bytes:
            total -= len(lines[at])
            at += 1
            dropped += 1
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(anchor)
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
