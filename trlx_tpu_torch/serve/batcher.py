"""The static micro-batcher and what both schedulers share: the request
object, the typed admission errors, tenant quotas and deadlines (port of
trlx_tpu.serve.batcher).

:class:`MicroBatcher` is the BATCH-TO-COMPLETION driver
(``serve.scheduler: static``): a flushed bucket decodes all its steps
(one ``generate`` per bucket, :meth:`InferenceEngine.decode`) before the
next batch starts; the slot scheduler (trlx_tpu_torch.serve.slots) is
the default. Requests queue, round UP to a ``(prompt_len, gen_len)``
shape class, and the worker flushes one bucket-shaped batch when either
enough same-shape requests queue to fill the class's largest batch
extent or the oldest has waited ``max_wait_ms``. The batch extent is
the smallest one holding every ready same-shape request; short batches
are padded with filler rows (never read back), and each completion is
de-padded and cut to its own ``max_new_tokens``.

Admission control: ``submit`` raises :class:`QueueFull` past
``max_queue`` (HTTP 429), :class:`Draining` once a drain began, and
:class:`QuotaExceeded` when the request's tenant is over its
``serve.tenants`` quota (:class:`TenantTable`: a token bucket, an
in-flight cap and a queue share; 429 with the tenant's own
``Retry-After``), while other tenants keep being admitted; the
``serve_quota`` chaos seam fires on that check. A request whose
``deadline_ms`` passed while it was queued is shed with
:class:`DeadlineExceeded` (503, ``serve/shed_expired``): the static
path checks at flush, the slot scheduler at every admission scan.
Containment: the worker enters the serve supervisor when one is given
and marks each decode as the ``serve_decode`` phase with a heartbeat
per batch; the ``serve_decode`` chaos seam fires inside it; a batch
that raises fails its requests and the loop keeps serving. Lifecycle:
:meth:`MicroBatcher.drain` finishes queued and in-flight work within
``serve.drain_timeout`` (leftovers get :class:`DrainTimeout`, 503);
:meth:`MicroBatcher.request_swap` installs new weights in place under
the engine's decode lock, probes the smallest bucket and rolls back if
the probe fails. Tracing (``serve.request_tracing``): each request
carries a :class:`~trlx_tpu_torch.serve.trace.RequestTrace`; a static
batch has no per-step timestamps, so its first token lands at decode
end and ITL is the uniform approximation.

Metrics: ``serve/queue_depth``, ``serve/batch_fill_ratio`` and
``serve/tokens_per_sec`` gauges, the ``serve/request_latency{path=
static}`` histogram (observed at trace completion, or at harvest with
tracing off), the ``serve/requests|responses|batches|rejected|
request_errors|generated_tokens|drains|reloads|reload_failures``
counters and the tenant-labeled ``serve/shed_quota{tenant=...}``.
"""

import contextlib
import itertools
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.serve.trace import RequestTrace
from trlx_tpu_torch.supervisor import chaos, monotonic


class QueueFull(RuntimeError):
    """Admission control rejection: the serve queue is at ``max_queue``.
    Clients should back off and retry (HTTP 429)."""


class Draining(QueueFull):
    """Admission rejection because the server is draining (SIGTERM or
    ``POST /admin/drain``): retry against another replica (HTTP 429 +
    ``Retry-After``). IS-A :class:`QueueFull` so scheduler-agnostic
    callers handle both the same way."""


class QuotaExceeded(QueueFull):
    """Per-tenant admission rejection: THIS tenant's quota
    (``serve.tenants`` rate bucket, ``max_inflight``, or
    ``max_queue_share``) is exhausted while the server itself may still
    have room — other tenants keep being admitted. IS-A
    :class:`QueueFull` (HTTP 429) so scheduler-agnostic callers need no
    new handling, but carries the tenant name and a per-tenant
    ``Retry-After`` derived from the tenant's own bucket refill instead
    of the global queue estimate."""

    def __init__(self, message: str, tenant: str = "",
                 retry_after_s: int = 1):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = int(retry_after_s)


class ReplayExhausted(RuntimeError):
    """A request's crash-only replay budget (``serve.max_replays``) ran
    out, or its grown prompt (original + committed tokens) no longer
    fits any compiled bucket — the request cannot be re-executed and
    fails with a typed reason (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """The request's own ``deadline_ms`` passed while it was still
    queued — shed by overload control instead of decoded uselessly
    (HTTP 503, ``serve/shed_expired``)."""


class DrainTimeout(RuntimeError):
    """The graceful-drain budget (``serve.drain_timeout``) expired with
    this request still unfinished; it is shed with a reason instead of
    killed with the process (HTTP 503)."""


#: global admission order: ties in priority admit FIFO by this stamp,
#: and replayed requests keep their original position
_SEQ = itertools.count()

#: tenant charged for requests that carry no ``X-Tenant-Id`` header /
#: ``"tenant"`` body field — quota config for it lives under the
#: ``serve.tenants`` ``"default"`` entry, which also governs tenants
#: the config does not name
DEFAULT_TENANT = "default"

_TENANT_KEYS = ("max_inflight", "max_queue_share", "rps", "burst",
                "priority")


class TenantPolicy:
    """One parsed ``serve.tenants`` entry.

    ``rps``/``burst`` form a token bucket (``rps <= 0`` disables rate
    limiting; ``burst <= 0`` defaults to ``max(1, rps)``);
    ``max_inflight`` caps admitted-but-unfinished requests (``<= 0``
    unlimited); ``max_queue_share`` caps the fraction of
    ``serve.max_queue`` the tenant's QUEUED requests may occupy
    (``<= 0`` unlimited); ``priority`` is the default admission
    priority for the tenant's requests — ``<= 0`` marks the tenant
    best-effort, i.e. brownout-clampable and router-sheddable under
    fleet pressure."""

    __slots__ = ("name", "max_inflight", "max_queue_share", "rps",
                 "burst", "priority")

    def __init__(self, name: str, spec):
        spec = dict(spec or {})
        unknown = sorted(set(spec) - set(_TENANT_KEYS))
        if unknown:
            raise ValueError(
                f"serve.tenants[{name!r}]: unknown keys {unknown} "
                f"(known: {list(_TENANT_KEYS)})"
            )
        self.name = name
        self.max_inflight = int(spec.get("max_inflight", 0))
        self.max_queue_share = float(spec.get("max_queue_share", 0.0))
        if self.max_queue_share > 1.0:
            raise ValueError(
                f"serve.tenants[{name!r}].max_queue_share="
                f"{self.max_queue_share:g} must be <= 1.0 (a fraction "
                f"of serve.max_queue)"
            )
        self.rps = float(spec.get("rps", 0.0))
        burst = float(spec.get("burst", 0.0))
        self.burst = burst if burst > 0 else max(1.0, self.rps)
        self.priority = int(spec.get("priority", 0))

    @property
    def best_effort(self) -> bool:
        return self.priority <= 0


class TenantTable:
    """Per-tenant admission accounting shared by both schedulers.

    NOT internally locked: callers invoke it under their own scheduler
    lock (the same discipline as router/resilience.RetryBudget). The
    ``"default"`` entry, when present, governs both the default tenant
    and any tenant the config does not name (they share its bucket);
    with no ``serve.tenants`` config at all every check is a no-op, so
    quota-free deployments pay nothing."""

    def __init__(self, config, max_queue: int):
        config = config or {}
        self.policies = {
            str(name): TenantPolicy(str(name), spec)
            for name, spec in config.items()
        }
        self.enabled = bool(self.policies)
        self.max_queue = int(max_queue)
        now = monotonic()
        self._buckets = {n: (p.burst, now)
                         for n, p in self.policies.items()}

    def policy(self, tenant: str) -> Optional[TenantPolicy]:
        p = self.policies.get(tenant)
        return self.policies.get(DEFAULT_TENANT) if p is None else p

    def priority_for(self, tenant: str) -> int:
        p = self.policy(tenant)
        return 0 if p is None else p.priority

    def best_effort(self, tenant: str) -> bool:
        p = self.policy(tenant)
        return True if p is None else p.best_effort

    def _refill(self, p: TenantPolicy, now: float) -> float:
        tokens, stamp = self._buckets[p.name]
        if p.rps > 0 and now > stamp:
            tokens = min(p.burst, tokens + (now - stamp) * p.rps)
        self._buckets[p.name] = (tokens, now)
        return tokens

    def _retry_after(self, p: TenantPolicy, now: float) -> int:
        """Seconds until the tenant's bucket holds a whole token again
        — the per-tenant Retry-After hint; >= 1 (HTTP header integer)."""
        if p.rps <= 0:
            return 1
        tokens, _ = self._buckets[p.name]
        deficit = (1.0 - tokens) / p.rps
        return max(1, int(-(-deficit // 1)))

    def try_admit(self, tenant: str, queued: int, inflight: int,
                  now: float) -> Optional[QuotaExceeded]:
        """One admission attempt for ``tenant`` currently holding
        ``queued`` queued and ``inflight`` running requests (counted by
        the caller under its lock). Returns None and spends one bucket
        token on success, or a ready-to-raise :class:`QuotaExceeded`
        (no token spent) naming the exhausted quota."""
        if not self.enabled:
            return None
        p = self.policy(tenant)
        if p is None:
            return None
        self._refill(p, now)
        if p.max_inflight > 0 and queued + inflight >= p.max_inflight:
            return QuotaExceeded(
                f"tenant {tenant!r} is at its max_inflight="
                f"{p.max_inflight} admitted-but-unfinished requests "
                f"(serve.tenants); retry after in-flight work drains",
                tenant=tenant, retry_after_s=self._retry_after(p, now),
            )
        if p.max_queue_share > 0 and queued >= max(
            1, int(p.max_queue_share * self.max_queue)
        ):
            return QuotaExceeded(
                f"tenant {tenant!r} holds its full "
                f"max_queue_share={p.max_queue_share:g} slice of the "
                f"{self.max_queue}-deep serve queue (serve.tenants); "
                f"other tenants keep their share — retry with backoff",
                tenant=tenant, retry_after_s=self._retry_after(p, now),
            )
        if p.rps > 0:
            tokens, _ = self._buckets[p.name]
            if tokens < 1.0:
                return QuotaExceeded(
                    f"tenant {tenant!r} is over its {p.rps:g} rps rate "
                    f"quota (burst {p.burst:g}, serve.tenants); retry "
                    f"after the bucket refills",
                    tenant=tenant,
                    retry_after_s=self._retry_after(p, now),
                )
            self._buckets[p.name] = (tokens - 1.0, now)
        return None

    def snapshot(self, now: float) -> Dict:
        """Debug view for ``/debug/state``: per-tenant bucket levels
        and policy knobs (never mutates bucket stamps)."""
        out = {}
        for name, p in self.policies.items():
            tokens, stamp = self._buckets[name]
            if p.rps > 0 and now > stamp:
                tokens = min(p.burst, tokens + (now - stamp) * p.rps)
            out[name] = {
                "tokens": round(tokens, 3), "rps": p.rps,
                "burst": p.burst, "max_inflight": p.max_inflight,
                "max_queue_share": p.max_queue_share,
                "priority": p.priority,
            }
        return out


def _validate_deadline(deadline_ms) -> Optional[float]:
    """HTTP ``deadline_ms`` -> seconds (None passes through); <= 0 is a
    request that could never be served, a caller bug (HTTP 400)."""
    if deadline_ms is None:
        return None
    deadline_ms = float(deadline_ms)
    if deadline_ms <= 0:
        raise ValueError(
            f"deadline_ms={deadline_ms:g} must be > 0 (the deadline is "
            f"relative to request receipt)"
        )
    return deadline_ms / 1000.0


def shed_expired(requests, now: float) -> List["Request"]:
    """Split off requests whose deadline passed while queued, failing
    each with :class:`DeadlineExceeded` (+ ``serve/shed_expired``);
    returns the survivors in order. Shared by both schedulers."""
    kept = []
    for req in requests:
        if req.deadline_at is not None and now > req.deadline_at:
            telemetry.inc("serve/shed_expired")
            telemetry.inc("serve/request_errors")
            req.error = DeadlineExceeded(
                f"request shed: its deadline_ms passed after "
                f"{(now - req.enqueued_at) * 1000.0:.0f}ms in queue "
                f"(overload — see serve/queue_depth and "
                f"serve/shed_expired)"
            )
            req.done.set()
        else:
            kept.append(req)
    return kept


class Request:
    """One queued generation request and its completion slot.

    Crash-only recovery journal: ``committed`` holds the tokens already
    harvested host-side — on a poisoned step the request is re-queued
    with them instead of failed, and re-admission prefills
    ``tokens + committed`` to resume decode from the last committed
    token (greedy decode is Markov on the token prefix, so the
    continuation is bit-identical). ``replays`` counts those re-queues
    against ``serve.max_replays``."""

    __slots__ = ("tokens", "max_new_tokens", "seed", "shape",
                 "enqueued_at", "done", "result", "error", "latency_s",
                 "trace", "seq", "priority", "deadline_at", "replays",
                 "committed", "model_version", "tenant", "age",
                 "degraded")

    def __init__(self, tokens: List[int], max_new_tokens: int,
                 shape, seed: Optional[int] = None,
                 trace: Optional[RequestTrace] = None,
                 deadline_s: Optional[float] = None,
                 priority: int = 0, tenant: str = DEFAULT_TENANT):
        self.tokens = tokens
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.shape = shape  # (prompt_len, gen_len) class
        self.enqueued_at = monotonic()
        self.done = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.latency_s: float = 0.0
        self.trace = trace
        self.seq = next(_SEQ)
        self.priority = int(priority)
        self.deadline_at = (
            None if deadline_s is None else self.enqueued_at + deadline_s
        )
        self.replays = 0
        self.committed: List[int] = []
        self.model_version = 0  # stamped at admission
        self.tenant = tenant
        #: admission rounds spent queued — feeds priority aging
        #: (serve.priority_aging_rounds) so low-priority tenants cannot
        #: be starved forever by a saturating high-priority stream
        self.age = 0
        #: True when brownout clamped this request's max_new_tokens
        #: (surfaced as "degraded": true in the HTTP response)
        self.degraded = False
        if trace is not None:
            trace.enqueued = self.enqueued_at
            trace.tenant = tenant

    def remaining_new_tokens(self) -> int:
        """Decode budget still owed after the committed prefix — always
        >= 1 for a live/queued request (a request whose last token was
        committed finished at that same harvest)."""
        return self.max_new_tokens - len(self.committed)

    def wait(self, timeout: Optional[float] = None) -> "Request":
        """Block until decoded; re-raises the worker-side error if the
        batch failed, raises TimeoutError if `timeout` expires first."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request not decoded within {timeout:.3g}s (queue "
                f"backlog or a stalled decode — check serve/queue_depth "
                f"and fault/stalls)"
            )
        if self.error is not None:
            raise self.error
        return self


class MicroBatcher:
    """The engine's static decode driver: one worker thread, one device
    program in flight at a time. Same ``submit`` / ``start`` / ``stop``
    / ``queue_depth`` / ``drain`` / ``request_swap`` surface as the slot
    scheduler."""

    def __init__(self, engine, max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None, run_supervisor=None):
        engine.check_graph_transport()
        self.engine = engine
        cfg = engine.serve
        self.max_wait_s = (
            cfg.max_wait_ms if max_wait_ms is None else max_wait_ms
        ) / 1000.0
        self.max_queue = cfg.max_queue if max_queue is None else max_queue
        self._tenants = TenantTable(cfg.tenants, self.max_queue)
        self._tracing = bool(cfg.request_tracing)
        self._slo_s = float(cfg.slo_ttft_ms) / 1000.0
        #: optional RunSupervisor, entered by the worker thread so its
        #: phase stack describes the decode loop
        self.run_supervisor = run_supervisor
        self._queue = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._final = False  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self._batch_counter = 0
        self._draining = False  # guarded-by: _cond
        self._inflight = 0  # requests inside the current _flush

    # -- lifecycle ------------------------------------------------------ #

    def warmup(self):
        return self.engine.warmup()

    @property
    def warmed(self) -> bool:
        return self.engine.warmed

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="trlx-torch-serve-batcher",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, final: bool = False) -> None:
        """Stop the worker and fail what is still queued; on a serve
        mesh, then end the followers' loops (once). With ``final`` (a
        server's shutdown) every later submit raises rather than queue
        for a start() that never comes."""
        if final:
            with self._cond:
                self._final = True
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.engine.close()
        # fail pending requests loudly rather than stranding waiters
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.error = RuntimeError("serve batcher stopped")
            req.done.set()

    # -- submission ----------------------------------------------------- #

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def submit(self, tokens: List[int], max_new_tokens: Optional[int] = None,
               seed: Optional[int] = None,
               trace: Optional[RequestTrace] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[int] = None,
               tenant: Optional[str] = None) -> Request:
        """Enqueue one request (bucket-rounded): ValueError when no
        bucket fits, QueueFull past ``max_queue``, :class:`QuotaExceeded`
        when THIS tenant's quota is spent, :class:`Draining` during a
        drain. An explicit ``trace`` (the HTTP edge's) is attached as
        it is; otherwise one is minted here when tracing is on.
        ``deadline_ms`` bounds queueing (checked at flush);
        ``priority=None`` takes the tenant's configured default."""
        if not tokens:
            raise ValueError("empty prompt: at least one token is required")
        if max_new_tokens is None:
            max_new_tokens = self.engine.default_max_new_tokens()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        deadline_s = _validate_deadline(deadline_ms)
        tenant = DEFAULT_TENANT if not tenant else str(tenant)
        if priority is None:
            priority = self._tenants.priority_for(tenant)
        shape = self.engine.pick_shape(len(tokens), max_new_tokens)
        if trace is None and self._tracing:
            trace = RequestTrace()
        req = Request(list(tokens), max_new_tokens, shape, seed=seed,
                      trace=trace, deadline_s=deadline_s,
                      priority=priority, tenant=tenant)
        if self._tenants.enabled:
            chaos.maybe_inject("serve_quota")
        with self._cond:
            if self._final:
                raise RuntimeError("serve batcher stopped")
            if self._draining:
                telemetry.inc("serve/rejected")
                raise Draining(
                    "server is draining: admission is closed while "
                    "in-flight requests finish (serve.drain_timeout); "
                    "retry against another replica"
                )
            denied = self._tenants.try_admit(
                tenant,
                queued=sum(1 for r in self._queue if r.tenant == tenant),
                inflight=0, now=monotonic(),
            )
            if denied is not None:
                telemetry.inc("serve/rejected")
                telemetry.inc("serve/shed_quota")
                telemetry.inc("serve/shed_quota",
                              labels={"tenant": tenant})
                raise denied
            if len(self._queue) >= self.max_queue:
                telemetry.inc("serve/rejected")
                raise QueueFull(
                    f"serve queue is full ({self.max_queue} pending); "
                    f"retry with backoff (serve.max_queue bounds queueing "
                    f"delay — raise it to trade latency for acceptance)"
                )
            self._queue.append(req)
            telemetry.inc("serve/requests")
            telemetry.set_gauge("serve/queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    # -- worker --------------------------------------------------------- #

    def _take_batch(self) -> List[Request]:
        """Block until a flushable batch exists: the head request's shape
        class either fills its largest batch extent or ages past
        ``max_wait_ms``. Returns [] only on shutdown."""
        with self._cond:
            while not self._stop.is_set():
                if not self._queue:
                    self._cond.wait(timeout=0.5)
                    continue
                head = self._queue[0]
                shape = head.shape
                ready = [r for r in self._queue if r.shape == shape]
                sizes = self.engine.batch_sizes_for(shape)
                deadline = head.enqueued_at + self.max_wait_s
                now = monotonic()
                if len(ready) < sizes[-1] and now < deadline:
                    self._cond.wait(timeout=deadline - now)
                    continue
                # the smallest extent holding every ready request; an
                # overfull queue flushes the largest and keeps the rest
                take_cap = next(
                    (b for b in sizes if b >= len(ready)), sizes[-1]
                )
                batch = ready[:take_cap]
                for r in batch:
                    self._queue.remove(r)
                # counted in flight before the lock drops: a drain never
                # sees an empty queue with this batch in neither place
                self._inflight = len(batch)
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
                return batch
            return []

    def _flush(self, batch: List[Request]) -> None:
        batch = shed_expired(batch, monotonic())
        if not batch:
            return
        version = self.engine.model_version
        for r in batch:
            r.model_version = version
            if r.trace is not None:
                r.trace.model_version = version
        shape = batch[0].shape
        sizes = self.engine.batch_sizes_for(shape)
        B = next(b for b in sizes if b >= len(batch))
        bucket = (B, shape[0], shape[1])
        # the batch seed: an explicit request seed wins (a one-request
        # batch is then reproducible), else serve.seed + a batch counter
        seeds = [r.seed for r in batch if r.seed is not None]
        seed = seeds[0] if seeds else (
            self.engine.serve.seed + self._batch_counter
        )
        self._batch_counter += 1
        tokens, mask = self.engine.pad_batch(
            [r.tokens for r in batch], bucket
        )
        admit_at = monotonic()
        for r in batch:
            if r.trace is not None:
                r.trace.admitted = admit_at
                r.trace.bucket = (B, shape[0])
        with supervisor.phase("serve_decode"):
            chaos.maybe_inject("serve_decode")
            out = self.engine.decode(bucket, tokens, mask, seed=seed)
            # a heartbeat per batch: only a batch that HANGS stalls
            supervisor.beat()
        done_at = monotonic()
        gen_total = 0
        for i, req in enumerate(batch):
            req.result = self.engine.depad_row(out, i, req.max_new_tokens)
            gen_total += len(req.result)
            req.latency_s = done_at - req.enqueued_at
            if req.trace is not None:
                req.trace.note_static_decode(
                    admit_at, done_at, len(req.result)
                )
                req.trace.harvested = done_at
                req.trace.complete("static", self._slo_s)
            else:
                telemetry.observe("serve/request_latency", req.latency_s,
                                  labels={"path": "static"})
            req.done.set()
        telemetry.inc("serve/responses", len(batch))
        telemetry.inc("serve/batches")
        telemetry.inc("serve/generated_tokens", gen_total)
        telemetry.set_gauge("serve/batch_fill_ratio", len(batch) / B)
        tel = telemetry.current()
        if tel is not None:
            hist = tel.registry.hists.get(
                f"time/{self.engine.span_name(bucket)}"
            )
            if hist is not None and hist.last > 0:
                telemetry.set_gauge(
                    "serve/tokens_per_sec", gen_total / hist.last
                )

    def _run(self) -> None:
        with self.run_supervisor or contextlib.nullcontext():
            while not self._stop.is_set():
                batch = self._take_batch()
                if not batch:
                    continue
                try:
                    self._flush(batch)
                except Exception as e:
                    # one poisoned batch must not kill the serving loop:
                    # fail ITS requests, count it, keep serving
                    telemetry.inc("serve/request_errors", len(batch))
                    for req in batch:
                        req.error = e
                        req.done.set()
                finally:
                    with self._cond:
                        self._inflight = 0
                        self._cond.notify_all()  # wake a waiting drain

    # -- overload and lifecycle ----------------------------------------- #

    def retry_after_s(self) -> int:
        """The 429 ``Retry-After`` hint: queue depth paced by the recent
        request-latency p50 over the average batch extent; never below
        1 s."""
        depth = self.queue_depth()
        per_req = 0.05
        tel = telemetry.current()
        if tel is not None:
            hist = tel.registry.hists.get(
                "serve/request_latency{path=static}"
            )
            if hist is not None and hist.count:
                per_req = max(hist.quantile(0.5), 1e-3)
        mean_batch = max(
            sum(b for b, _, _ in self.engine.buckets)
            / len(self.engine.buckets), 1.0,
        )
        return max(1, int(-(-depth * per_req // mean_batch)))

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: close admission (submit -> :class:`Draining`),
        let queued and in-flight requests finish within ``timeout``
        (default ``serve.drain_timeout``), shed leftovers with
        :class:`DrainTimeout`, stop the worker. Returns True when
        everything finished inside the budget."""
        if timeout is None:
            timeout = float(self.engine.serve.drain_timeout)
        with self._cond:
            first = not self._draining
            self._draining = True
        if first:
            telemetry.inc("serve/drains")
        deadline = monotonic() + timeout
        clean = True
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - monotonic()
                if remaining <= 0 or self._thread is None:
                    clean = False
                    break
                self._cond.wait(timeout=min(remaining, 0.1))
        if not clean:
            with self._cond:
                pending = list(self._queue)
                self._queue.clear()
            telemetry.inc("serve/request_errors", len(pending))
            for req in pending:
                req.error = DrainTimeout(
                    f"server drained: request shed after the "
                    f"{timeout:.3g}s serve.drain_timeout budget expired "
                    f"with it still queued; retry against another replica"
                )
                req.done.set()
        self.stop()
        return clean

    def request_swap(self, params, label: str = "") -> Dict:
        """Live weight swap for the static path: strip and validate the
        candidate, then under the engine's decode lock (so no decode
        sees a torn weight set) install it IN PLACE — the captured
        graphs read the engine's own tensors — and probe the smallest
        bucket through its existing graph; non-finite logprobs (or a
        probe that raises) swap the previous weights back. Zero
        recompiles either way. Returns the reload verdict dict.

        On a serve mesh of several processes ``label`` is the checkpoint
        directory ``params`` came from: the install, the probe and the
        commit or rollback reach every follower, which restores its own
        slices of it (:meth:`InferenceEngine.install`). The
        ``serve_reload`` seam fires before anything is published."""
        chaos.maybe_inject("serve_reload")
        e = self.engine
        views = e.strip_for_serve(params)
        e.validate_swap(views)
        old_version = e.model_version
        B, P, G = e.buckets[0]
        tokens = np.full((B, P), e.pad_token_id, np.int32)
        tokens[:, -1] = 0
        mask = np.zeros((B, P), np.int32)
        mask[:, -1] = 1
        detail = ""
        with e._lock:  # no decode mid-dispatch sees a torn weight set
            e.install(label, views)  # views now hold the previous weights
            del views
            try:
                out = e.decode((B, P, G), tokens, mask, seed=0)
                ok = bool(np.all(np.isfinite(out.gen_logprobs)))
                if not ok:
                    detail = "smoke probe produced non-finite logprobs"
            except Exception as exc:
                ok = False
                detail = f"smoke probe failed: {exc!r}"
            e.end_swap(rollback=not ok)  # a rollback: the previous weights
        if not ok:
            telemetry.inc("serve/reload_failures")
            return {"reloaded": False, "model_version": old_version,
                    "reason": detail}
        e.commit_version(label or None)
        telemetry.inc("serve/reloads")
        return {"reloaded": True, "model_version": e.model_version,
                "previous_version": old_version}
