"""The static micro-batcher and the request objects both schedulers
share (port of trlx_tpu.serve.batcher ``:64-120, 314-735``).

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
``max_queue`` (HTTP 429). Containment: the worker enters the serve
supervisor when one is given and marks each decode as the
``serve_decode`` phase with a heartbeat per batch; the ``serve_decode``
chaos seam fires inside it; a batch that raises fails its requests and
the loop keeps serving.

Metrics: ``serve/queue_depth``, ``serve/batch_fill_ratio`` and
``serve/tokens_per_sec`` gauges, the ``serve/request_latency{path=
static}`` histogram, the ``serve/requests|responses|batches|rejected|
request_errors|generated_tokens`` counters.

Not ported in this slice: tenants and quotas, deadlines and shedding,
graceful drain, hot-swap and request tracing.
"""

import contextlib
import itertools
import threading
from collections import deque
from typing import List, Optional

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.supervisor import chaos, monotonic


class QueueFull(RuntimeError):
    """Admission control rejection: the serve queue is at ``max_queue``.
    Clients should back off and retry (HTTP 429)."""


#: global admission order: same-class requests admit FIFO by this stamp
_SEQ = itertools.count()


class Request:
    """One queued generation request and its completion slot."""

    __slots__ = ("tokens", "max_new_tokens", "seed", "shape",
                 "enqueued_at", "done", "result", "error", "latency_s",
                 "seq")

    def __init__(self, tokens: List[int], max_new_tokens: int, shape,
                 seed: Optional[int] = None):
        self.tokens = tokens
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.shape = shape  # (prompt_len, gen_len) class
        self.enqueued_at = monotonic()
        self.done = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.latency_s: float = 0.0
        self.seq = next(_SEQ)

    def wait(self, timeout: Optional[float] = None) -> "Request":
        """Block until decoded; re-raises the worker-side error if the
        step failed, raises TimeoutError if `timeout` expires first."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request not decoded within {timeout:.3g}s (queue "
                f"backlog or a stalled decode — check serve/queue_depth)"
            )
        if self.error is not None:
            raise self.error
        return self


class MicroBatcher:
    """The engine's static decode driver: one worker thread, one device
    program in flight at a time. Same ``submit`` / ``start`` / ``stop``
    / ``queue_depth`` surface as the slot scheduler."""

    def __init__(self, engine, max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None, run_supervisor=None):
        self.engine = engine
        cfg = engine.serve
        self.max_wait_s = (
            cfg.max_wait_ms if max_wait_ms is None else max_wait_ms
        ) / 1000.0
        self.max_queue = cfg.max_queue if max_queue is None else max_queue
        #: optional RunSupervisor, entered by the worker thread so its
        #: phase stack describes the decode loop
        self.run_supervisor = run_supervisor
        self._queue = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batch_counter = 0

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

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
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
               seed: Optional[int] = None) -> Request:
        """Enqueue one request (bucket-rounded): ValueError when no
        bucket fits, QueueFull past ``max_queue``."""
        if not tokens:
            raise ValueError("empty prompt: at least one token is required")
        if max_new_tokens is None:
            max_new_tokens = self.engine.default_max_new_tokens()
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        shape = self.engine.pick_shape(len(tokens), max_new_tokens)
        req = Request(list(tokens), max_new_tokens, shape, seed=seed)
        with self._cond:
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
                telemetry.set_gauge("serve/queue_depth", len(self._queue))
                return batch
            return []

    def _flush(self, batch: List[Request]) -> None:
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
        sup_cm = self.run_supervisor or contextlib.nullcontext()
        with sup_cm:
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
