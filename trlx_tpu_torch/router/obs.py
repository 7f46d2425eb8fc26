"""Router-side request observability: stitched fleet traces (copy of
trlx_tpu.router.obs).

A replica's :class:`~trlx_tpu_torch.serve.trace.RequestTrace` explains
one process; it cannot explain why a request took far longer end to end
than its winning replica's decode — the missing time lived in the
ROUTER: a breaker-gated pick, a slow primary, a hedge that fired, a
failover after a kill. This module records that half and stitches the
two together into ONE fleet-level trace per request, keyed by the
``X-Request-Id`` that already flows through every hop:

- :class:`FleetTrace` — the per-request event timeline the router
  appends to as it works: ``pick`` (with the affinity outcome and
  predicted depth), ``attempt`` / ``attempt_ok`` / ``attempt_fail``,
  ``hedge_fire`` / ``hedge_win`` / ``hedge_lose`` /
  ``hedge_suppressed``, ``failover``, ``breaker_strike`` /
  ``breaker_open`` / ``breaker_close``, ``retry_budget_spend`` /
  ``retry_budget_exhausted``, each stamped with a millisecond offset
  from request start. ``finish()`` merges the winning replica's
  returned ``trace`` payload (the router always forwards
  ``"trace": true``) and derives the tail flags.
- :class:`TraceRing` — a bounded id-keyed ring of finished traces
  behind ``GET /debug/trace/<id>`` (and ``GET /debug/trace`` for the
  recent-id listing). Newest wins; memory is O(capacity).
- :class:`AccessLog` — a sampled, size-rotated ``access.jsonl`` of the
  same records: every Nth request is written (deterministic counter,
  not RNG — replayable in tests) and TAIL-BASED capture forces a write
  for any request that breached SLO, errored, hedged, or failed over,
  so the interesting 1% is always on disk while steady-state traffic
  costs 1/N the bytes. Rotation renames to ``<path>.1`` when the file
  would exceed the budget (one generation kept — bounded by 2x).
- :class:`RouterObs` — the facade the router calls. ``begin()``
  returns None when tracing is disabled or no telemetry session is
  active (``telemetry: false`` records NOTHING — same contract as the
  metrics registry), and every router call site is None-guarded, so
  the disabled path costs one attribute check.

Everything here is stdlib-only (json/os/threading/collections) and all
timing is ``trlx_tpu_torch.supervisor.monotonic`` — the router's clock.
"""

import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.supervisor import monotonic


class FleetTrace:
    """Event timeline for ONE routed request.

    ``event()`` appends are taken under a lock: the hedging race means
    a losing attempt's thread can strike its breaker while the winner's
    thread is finishing the trace."""

    __slots__ = ("trace_id", "started", "events", "hedged",
                 "failed_over", "breaker_opened", "_lock")

    def __init__(self, trace_id: str,
                 started: Optional[float] = None):
        self.trace_id = trace_id
        self.started = monotonic() if started is None else started
        self.events: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.hedged = False
        self.failed_over = False
        self.breaker_opened = False
        self._lock = threading.Lock()

    def event(self, kind: str, **fields) -> None:
        rec: Dict[str, Any] = {
            "t_ms": round((monotonic() - self.started) * 1000.0, 3),
            "event": kind,
        }
        rec.update(fields)
        with self._lock:
            self.events.append(rec)
            if kind == "hedge_fire":
                self.hedged = True
            elif kind == "failover":
                self.failed_over = True
            elif kind == "breaker_open":
                self.breaker_opened = True

    def finish(self, status: int, backend: Optional[str] = None,
               replica_trace: Optional[dict] = None,
               error: Optional[str] = None,
               slo_ttft_ms: float = 0.0) -> Dict[str, Any]:
        """Seal the trace into the stitched record: router events +
        the winning replica's span payload + derived tail flags."""
        elapsed_ms = round((monotonic() - self.started) * 1000.0, 3)
        ttft_ms = None
        if isinstance(replica_trace, dict):
            ttft_ms = replica_trace.get("ttft_ms")
        slo_breached = bool(
            slo_ttft_ms > 0 and ttft_ms is not None
            and ttft_ms > slo_ttft_ms
        )
        with self._lock:
            record: Dict[str, Any] = {
                "trace_id": self.trace_id,
                "status": int(status),
                "backend": backend,
                "elapsed_ms": elapsed_ms,
                "hedged": self.hedged,
                "failed_over": self.failed_over,
                "breaker_opened": self.breaker_opened,
                "slo_breached": slo_breached,
                "events": list(self.events),
            }
        if error:
            record["error"] = str(error)
        if isinstance(replica_trace, dict):
            record["replica"] = dict(replica_trace)
        return record


def is_tail(record: Dict[str, Any]) -> bool:
    """The always-capture predicate: breached SLO, errored, hedged, or
    failed over — the requests a post-mortem actually reads."""
    return bool(
        record.get("slo_breached")
        or record.get("status", 200) != 200
        or record.get("hedged")
        or record.get("failed_over")
    )


class TraceRing:
    """Bounded id -> finished-record map (insertion-ordered; oldest
    evicted). Writers are HTTP handler threads, readers the debug
    endpoint — every touch under the lock."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._records: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()

    def put(self, record: Dict[str, Any]) -> None:
        trace_id = str(record.get("trace_id"))
        with self._lock:
            self._records.pop(trace_id, None)
            self._records[trace_id] = record
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._records.get(trace_id)

    def ids(self) -> List[str]:
        """Most-recent-first id listing (the ``/debug/trace`` index)."""
        with self._lock:
            return list(reversed(self._records))


class AccessLog:
    """Sampled, size-rotated JSONL sink for stitched records."""

    def __init__(self, path: str, sample_every: int = 20,
                 max_bytes: int = 64 * 1024 * 1024):
        self.path = path
        self.sample_every = max(int(sample_every), 1)
        self.max_bytes = max(int(max_bytes), 1)
        self._lock = threading.Lock()
        self._seen = 0      # guarded-by: _lock
        self._sampled_out = 0  # guarded-by: _lock
        self._size: Optional[int] = None  # guarded-by: _lock

    def write(self, record: Dict[str, Any], force: bool = False) -> bool:
        """Append ``record`` if it samples in (or ``force``); returns
        whether a line was written."""
        line = json.dumps(record, sort_keys=True) + "\n"
        with self._lock:
            self._seen += 1
            if not force and (self._seen - 1) % self.sample_every:
                self._sampled_out += 1
                return False
            if self._size is None:
                try:
                    self._size = os.path.getsize(self.path)
                except OSError:
                    self._size = 0
            if self._size and self._size + len(line) > self.max_bytes:
                os.replace(self.path, self.path + ".1")
                self._size = 0
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line)
            self._size += len(line)
        return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"seen": self._seen, "sampled_out": self._sampled_out}


class RouterObs:
    """The router's observability facade: trace ring + access log.

    Construction is cheap; per-request recording only happens when
    ``begin()`` hands out a :class:`FleetTrace` — which it refuses when
    both sinks are disabled OR no telemetry session is active."""

    def __init__(self, trace_ring: int = 256, access_log: str = "",
                 access_log_sample: int = 20,
                 access_log_max_bytes: int = 64 * 1024 * 1024):
        self.ring = TraceRing(trace_ring) if trace_ring > 0 else None
        self.log = AccessLog(
            access_log, sample_every=access_log_sample,
            max_bytes=access_log_max_bytes,
        ) if access_log else None

    def begin(self, trace_id: str) -> Optional[FleetTrace]:
        if (self.ring is None and self.log is None) \
                or telemetry.current() is None:
            return None
        return FleetTrace(trace_id)

    def finish(self, ftrace: Optional[FleetTrace], status: int,
               backend: Optional[str] = None,
               replica_trace: Optional[dict] = None,
               error: Optional[str] = None,
               slo_ttft_ms: float = 0.0) -> Optional[Dict[str, Any]]:
        """Seal + sink one trace: into the ring always, into the access
        log by sampling — with tail-based ALWAYS-capture for the
        breached/errored/hedged/failed-over requests."""
        if ftrace is None:
            return None
        record = ftrace.finish(
            status, backend=backend, replica_trace=replica_trace,
            error=error, slo_ttft_ms=slo_ttft_ms,
        )
        if self.ring is not None:
            self.ring.put(record)
        if self.log is not None:
            self.log.write(record, force=is_tail(record))
        return record
