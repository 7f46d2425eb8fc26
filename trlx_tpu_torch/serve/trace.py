"""Request-lifecycle tracing and the engine-step flight recorder (port
of trlx_tpu.serve.trace; host code only, nothing here touches a CUDA
tensor).

- :class:`RequestTrace` — one per request (``serve.request_tracing``,
  default on). A trace id is minted at the HTTP edge (an inbound
  ``X-Request-Id`` is honoured) and the record collects monotonic
  timestamps at every lifecycle edge: received, enqueued, admitted
  (pages reserved, prefix blocks hit, queue re-entries), prefill start
  and end (bucket, suffix length), first token, per-step token times
  folded into an ITL count / total / min / max (never stored raw),
  harvested, responded. :meth:`RequestTrace.complete` derives the SLO
  family — ``serve/ttft``, ``serve/itl``, ``serve/queue_time``,
  ``serve/prefill_time``, ``serve/decode_time``, the
  ``serve/request_latency{path="slots"|"static"}`` histogram and the
  ``serve/goodput`` gauge (the share of requests whose TTFT beat
  ``serve.slo_ttft_ms``) — and exports the request as its own Perfetto
  track through the session's tracer (``telemetry/tracer.py``
  ``add_span``).
- :class:`SloEngine` / :class:`SloWindow` — windowed goodput per label
  set and the error-budget burn rates (``slo/goodput_5m``,
  ``slo/goodput_1h``, ``slo/burn_rate_fast``, ``slo/burn_rate_slow``);
  it hangs off the telemetry session (``tel.slo``), so ``telemetry``
  off records nothing; ``GET /debug/slo`` serves
  :meth:`SloEngine.snapshot`.
- :class:`FlightRecorder` — a fixed ring (``serve.flight_recorder_steps``)
  of one compact record per engine step (step, active and finished
  lanes, occupancy, pages free, admissions, step wall time), dumped to
  stderr on a watchdog stall, a poisoned step or a drain, and served at
  ``GET /debug/state``.

On the card the timestamps are host clocks taken where the host already
has the step's results (the step's one device-to-host copy), so tracing
adds no synchronisation. Every timestamp is
``trlx_tpu_torch.supervisor.monotonic``.
"""

import itertools
import json
import sys
import threading
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.supervisor import monotonic

#: the SLO histogram family complete() observes (docs "Observability");
#: the server predeclares the counters so scrapes see zeros, not gaps
SLO_COUNTERS = ("serve/slo_good", "serve/slo_total", "serve/flight_dumps")


class SloWindow:
    """Sliding two-window good/total accounting for ONE series.

    Time is coarsened into fixed buckets (``slow_s / buckets`` wide);
    each bucket holds (good, total) tallies and buckets older than the
    slow window are expired on write — memory is O(buckets) no matter
    how long the run. ``counts(window_s, now)`` sums the buckets inside
    the trailing window (bucket-granular, which is exactly the
    resolution an alerting burn rate needs)."""

    __slots__ = ("fast_s", "slow_s", "bucket_s", "_buckets")

    def __init__(self, fast_s: float = 300.0, slow_s: float = 3600.0,
                 buckets: int = 120):
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.bucket_s = max(self.slow_s / max(int(buckets), 1), 1e-9)
        self._buckets: deque = deque()  # [bucket_idx, good, total]

    def record(self, ok: bool, now: float) -> None:
        idx = int(now / self.bucket_s)
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append([idx, 0, 0])
        bucket = self._buckets[-1]
        if ok:
            bucket[1] += 1
        bucket[2] += 1
        floor = idx - int(self.slow_s / self.bucket_s) - 1
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.popleft()

    def counts(self, window_s: float, now: float) -> Tuple[int, int]:
        floor = int((now - window_s) / self.bucket_s)
        good = total = 0
        for idx, g, t in self._buckets:
            if idx > floor:
                good += g
                total += t
        return good, total


class SloEngine:
    """Per-label-set sliding SLO accounting + burn-rate gauges.

    ``record(ok, now, labels=...)`` folds one scored request into that
    label set's :class:`SloWindow` and refreshes the four windowed
    gauges WITH the labels (``slo/goodput_5m{path="slots"}``, …). The
    gauge names are canonical even when the windows are configured
    shorter (tests use sub-second windows); an empty window reads
    goodput 1.0 / burn 0.0 — no data is not an outage. Burn rate is
    (1 - goodput) / (1 - target): 1.0 means the error budget burns
    exactly at the rate that exhausts it over the window; a paging
    threshold is a multiple of that (docs "Observability", runbook)."""

    def __init__(self, target: float = 0.99, fast_s: float = 300.0,
                 slow_s: float = 3600.0):
        self.target = float(target)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self._lock = threading.Lock()
        self._series: Dict[tuple, SloWindow] = {}  # guarded-by: _lock

    def burn_rate(self, goodput: float) -> float:
        budget = 1.0 - self.target
        return (1.0 - goodput) / budget if budget > 0 else 0.0

    def record(self, ok: bool, now: Optional[float] = None,
               labels: Optional[Dict[str, Any]] = None) -> None:
        now = monotonic() if now is None else now
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            win = self._series.get(key)
            if win is None:
                win = self._series[key] = SloWindow(self.fast_s,
                                                    self.slow_s)
            win.record(bool(ok), now)
            good_f, tot_f = win.counts(self.fast_s, now)
            good_s, tot_s = win.counts(self.slow_s, now)
        gp_fast = good_f / tot_f if tot_f else 1.0
        gp_slow = good_s / tot_s if tot_s else 1.0
        telemetry.set_gauge("slo/goodput_5m", gp_fast, labels=labels)
        telemetry.set_gauge("slo/goodput_1h", gp_slow, labels=labels)
        telemetry.set_gauge("slo/burn_rate_fast", self.burn_rate(gp_fast),
                            labels=labels)
        telemetry.set_gauge("slo/burn_rate_slow", self.burn_rate(gp_slow),
                            labels=labels)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/debug/slo`` body: target, window lengths, and one
        entry per label set with live counts/goodput/burn rates."""
        now = monotonic() if now is None else now
        series = []
        with self._lock:
            items = sorted(self._series.items())
            for key, win in items:
                good_f, tot_f = win.counts(self.fast_s, now)
                good_s, tot_s = win.counts(self.slow_s, now)
                gp_fast = good_f / tot_f if tot_f else 1.0
                gp_slow = good_s / tot_s if tot_s else 1.0
                series.append({
                    "labels": dict(key),
                    "good_fast": good_f, "total_fast": tot_f,
                    "good_slow": good_s, "total_slow": tot_s,
                    "goodput_fast": round(gp_fast, 6),
                    "goodput_slow": round(gp_slow, 6),
                    "burn_rate_fast": round(self.burn_rate(gp_fast), 6),
                    "burn_rate_slow": round(self.burn_rate(gp_slow), 6),
                })
        return {
            "target": self.target,
            "fast_window_s": self.fast_s,
            "slow_window_s": self.slow_s,
            "series": series,
        }


def slo_engine(target: Optional[float] = None):
    """The active session's :class:`SloEngine`, created on first use
    (None without a session — the ``telemetry: false`` no-op gate).
    Passing ``target`` re-pins the objective (server/router start)."""
    tel = telemetry.current()
    if tel is None:
        return None
    if tel.slo is None:
        tel.slo = SloEngine()
    if target is not None:
        tel.slo.target = float(target)
    return tel.slo

#: Perfetto track ids: one per request, starting clear of tid 0 (the
#: process-level span track the tracer already uses)
_TID = itertools.count(1)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """Monotonic lifecycle timestamps + ITL aggregate for one request.

    All fields are plain floats/ints written by whichever thread owns
    that lifecycle edge (HTTP handler, scheduler worker) — never two at
    once, so no locking. Unset edges stay 0.0.
    """

    __slots__ = (
        "trace_id", "tid", "received", "enqueued", "admitted",
        "prefill_start", "prefill_end", "first_token", "last_token",
        "harvested", "responded", "queue_reentries", "pages_reserved",
        "prefix_blocks_hit", "bucket", "suffix_len",
        "itl_count", "itl_total", "itl_min", "itl_max",
        "replays", "model_version", "tenant",
    )

    def __init__(self, trace_id: Optional[str] = None,
                 received: Optional[float] = None):
        self.trace_id = trace_id or new_trace_id()
        self.tid = next(_TID)
        self.received = monotonic() if received is None else received
        self.enqueued = 0.0
        self.admitted = 0.0
        self.prefill_start = 0.0
        self.prefill_end = 0.0
        self.first_token = 0.0
        self.last_token = 0.0
        self.harvested = 0.0
        self.responded = 0.0
        self.queue_reentries = 0
        self.pages_reserved = 0
        self.prefix_blocks_hit = 0
        self.bucket = None  # (batch_extent, prompt_len) admission bucket
        self.suffix_len = 0
        self.itl_count = 0
        self.itl_total = 0.0
        self.itl_min = 0.0
        self.itl_max = 0.0
        #: crash-only recovery: poisoned-step/admission re-queues this
        #: request survived (trlx_tpu_torch.serve.slots replay path)
        self.replays = 0
        #: the weight generation that ADMITTED this request (hot-swap
        #: audit trail; engine.model_version at admission)
        self.model_version = 0
        #: tenant charged for this request (overload containment; set at
        #: submit; feeds slo/goodput_5m{tenant=...} at completion)
        self.tenant = "default"

    # -- lifecycle edges -------------------------------------------------- #

    def note_token(self, now: float) -> None:
        """One emitted token at ``now`` (the step's harvest timestamp).
        The first sets TTFT's numerator; later ones fold their gap into
        the ITL aggregate AND the global ``serve/itl`` histogram (the
        per-gap distribution — raw timestamps are never stored)."""
        if not self.first_token:
            self.first_token = now
        else:
            gap = now - self.last_token
            if not self.itl_count or gap < self.itl_min:
                self.itl_min = gap
            if gap > self.itl_max:
                self.itl_max = gap
            self.itl_count += 1
            self.itl_total += gap
            telemetry.observe("serve/itl", gap)
        self.last_token = now

    def note_static_decode(self, start: float, end: float,
                           n_tokens: int) -> None:
        """The batch-to-completion path has no per-step timestamps — the
        whole decode is one program, so its first token materializes at
        decode END and ITL is the uniform ``decode_time / tokens``
        approximation (one ``serve/itl`` observation per request, not
        per gap, as trlx_tpu documents it)."""
        self.prefill_start = self.prefill_end = start
        self.first_token = self.last_token = end
        if n_tokens > 1:
            gap = (end - start) / n_tokens
            self.itl_count = n_tokens - 1
            self.itl_total = gap * self.itl_count
            self.itl_min = self.itl_max = gap
            telemetry.observe("serve/itl", gap)

    def itl_mean(self) -> float:
        return self.itl_total / self.itl_count if self.itl_count else 0.0

    def ttft(self) -> float:
        base = self.received or self.enqueued
        return max(self.first_token - base, 0.0) if self.first_token \
            else 0.0

    # -- completion -------------------------------------------------------- #

    def complete(self, path: str, slo_ttft_s: float) -> None:
        """Harvest-time derivation: observe the SLO histogram family,
        update goodput, and export this request as a Perfetto track.
        Called once by the scheduler that finished the request (works
        for direct ``submit()`` callers too — bench/tests never touch
        HTTP); ``responded`` is stamped later by the HTTP layer and
        appears in the JSON trace, not in the exported spans."""
        telemetry.observe("serve/ttft", self.ttft())
        if self.admitted:
            telemetry.observe(
                "serve/queue_time", max(self.admitted - self.enqueued, 0.0)
            )
        if self.prefill_end:
            telemetry.observe(
                "serve/prefill_time", self.prefill_end - self.prefill_start
            )
            telemetry.observe(
                "serve/decode_time", max(self.harvested - self.prefill_end,
                                         0.0)
            )
        telemetry.observe(
            "serve/request_latency", self.harvested - self.enqueued,
            labels={"path": path},
        )
        telemetry.inc("serve/slo_total")
        tel = telemetry.current()
        if tel is None:
            return
        ok = slo_ttft_s <= 0 or self.ttft() <= slo_ttft_s
        good = tel.registry.inc("serve/slo_good", 1.0 if ok else 0.0)
        total = tel.registry.counters.get("serve/slo_total", 1.0)
        tel.registry.set_gauge("serve/goodput", good / max(total, 1.0))
        slo_engine().record(
            ok, now=self.harvested or None, labels={"path": path}
        )
        # second label axis, not a combined set: per-tenant goodput
        # (slo/goodput_5m{tenant=...}) must aggregate across paths for
        # the isolation drill's premium-tenant floor
        slo_engine().record(
            ok, now=self.harvested or None,
            labels={"tenant": self.tenant},
        )
        self._export_spans(tel.tracer)

    def _export_spans(self, tracer) -> None:
        """One Perfetto track per request (this trace's ``tid``): a
        parent ``serve/request`` span over the whole lifecycle with
        queue/prefill/decode child spans nested inside it."""
        end = self.harvested or self.last_token or self.admitted \
            or self.enqueued
        start = self.received or self.enqueued
        if end <= 0 or start <= 0:
            return
        tracer.name_track(self.tid, f"req {self.trace_id}")
        args: Dict[str, Any] = {"trace_id": self.trace_id}
        if self.bucket is not None:
            args["bucket"] = list(self.bucket)
        if self.pages_reserved:
            args["pages_reserved"] = self.pages_reserved
        if self.prefix_blocks_hit:
            args["prefix_blocks_hit"] = self.prefix_blocks_hit
        if self.queue_reentries:
            args["queue_reentries"] = self.queue_reentries
        if self.replays:
            args["replays"] = self.replays
        if self.model_version:
            args["model_version"] = self.model_version
        tracer.add_span("serve/request", start, end, tid=self.tid,
                        args=args)
        if self.admitted:
            tracer.add_span("serve/req_queue", self.enqueued, self.admitted,
                            tid=self.tid)
        if self.prefill_end:
            tracer.add_span("serve/req_prefill", self.prefill_start,
                            self.prefill_end, tid=self.tid)
            tracer.add_span("serve/req_decode", self.prefill_end, end,
                            tid=self.tid)

    # -- export ------------------------------------------------------------ #

    def to_dict(self) -> Dict[str, Any]:
        """The opt-in ``"trace": true`` response payload — millisecond
        durations (the JSON consumer never sees raw monotonic values)."""
        ms = 1000.0
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "ttft_ms": round(self.ttft() * ms, 3),
            "queue_ms": round(
                max(self.admitted - self.enqueued, 0.0) * ms, 3
            ) if self.admitted else 0.0,
            "prefill_ms": round(
                (self.prefill_end - self.prefill_start) * ms, 3
            ) if self.prefill_end else 0.0,
            "decode_ms": round(
                max(self.harvested - self.prefill_end, 0.0) * ms, 3
            ) if self.prefill_end else 0.0,
            "total_ms": round(
                max((self.responded or self.harvested) - self.received, 0.0)
                * ms, 3
            ),
            "itl_mean_ms": round(self.itl_mean() * ms, 3),
            "itl_min_ms": round(self.itl_min * ms, 3),
            "itl_max_ms": round(self.itl_max * ms, 3),
            "tokens": self.itl_count + 1 if self.first_token else 0,
            "queue_reentries": self.queue_reentries,
        }
        if self.replays:
            out["replays"] = self.replays
        if self.model_version:
            out["model_version"] = self.model_version
        if self.bucket is not None:
            out["bucket"] = list(self.bucket)
        if self.pages_reserved:
            out["pages_reserved"] = self.pages_reserved
            out["prefix_blocks_hit"] = self.prefix_blocks_hit
            out["suffix_len"] = self.suffix_len
        return out


class FlightRecorder:
    """Fixed-size ring of per-engine-step records; the black box the
    stall/chaos/poison dump paths read back. All appends happen on the
    scheduler worker thread; ``snapshot()`` copies under the GIL, so the
    HTTP ``/debug/state`` reader needs no lock."""

    def __init__(self, steps: int = 256):
        self.ring = deque(maxlen=max(int(steps), 1))
        self.dumps = 0

    def record(self, **fields) -> None:
        self.ring.append(fields)

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self.ring)

    def dump(self, reason: str, limit: int = 64) -> None:
        """Print the last ``limit`` records to stderr (one JSON object
        per line — grep-able next to the watchdog's stack dump)."""
        records = self.snapshot()[-limit:]
        self.dumps += 1
        telemetry.inc("serve/flight_dumps")
        print(
            f"[trlx_tpu_torch.serve] FLIGHT RECORDER ({reason}): last "
            f"{len(records)} engine steps:",
            file=sys.stderr, flush=True,
        )
        for rec in records:
            print("[trlx_tpu_torch.serve] " + json.dumps(rec), file=sys.stderr)
        sys.stderr.flush()
