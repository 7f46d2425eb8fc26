"""Stdlib HTTP endpoint over the inference engine and its decode driver
(port of trlx_tpu.serve.server): the slot scheduler, or under
``serve.scheduler: static`` the micro-batcher; both have the same
submit / wait / drain / swap surface.

``ThreadingHTTPServer`` + JSON, no extra dependencies:

- ``POST /generate`` — body ``{"prompt": str | "tokens": [int],
  "max_new_tokens": int?, "seed": int?, "tenant": str?, "priority":
  int?, "deadline_ms": float?, "trace": bool?}``; returns the
  completion's tokens and text, the shape class that served it, the
  measured queue + decode latency, the ``model_version`` that admitted
  it and (tracing on) its ``trace_id`` — minted at this edge, or taken
  from an inbound ``X-Request-Id`` and echoed back in that header.
  ``"trace": true`` adds the request's lifecycle breakdown
  (:meth:`~trlx_tpu_torch.serve.trace.RequestTrace.to_dict`); a
  brownout-clamped answer carries ``"degraded": true``. The tenant is
  the ``X-Tenant-Id`` header, else the body's ``tenant``. Every field
  trlx_tpu honours is honoured (others are ignored, as there). Errors
  are typed: 400 (bad request, no bucket fits), 429 (queue full,
  draining, or the tenant over its quota, with ``Retry-After``), 503
  (replay budget spent, deadline passed in the queue, drain deadline,
  or not decoded within ``serve.request_timeout``), 508 (``X-Hop-Count``
  over :data:`MAX_HOPS`: a proxy loop), 500 (decode failure).
- ``GET /healthz`` — liveness, the scheduler, lattice, queue depth and,
  under the slot scheduler, its slots, free slots and the pool's ``kv``
  block; the ``mesh`` block (devices, axes, weight placement, params GB
  per device); ``recompiles`` (the ``compile/recompiles`` counter: 0
  once warmed, the serving invariant).
- ``GET /readyz`` — readiness: 200 only while warmed and admitting (503
  once a drain began), with ``model_version`` and the scheduler's
  ``pressure`` block.
- ``GET /metrics`` — content-negotiated: the telemetry registry summary
  as JSON by default; an ``Accept`` naming ``text/plain``,
  ``openmetrics`` or ``prometheus`` gets the Prometheus text exposition
  (trlx_tpu_torch.telemetry.prometheus).
- ``GET /debug/state`` — the live engine state (slot map, flight
  recorder, KV pool, tenants, pressure); ``GET /debug/slo`` — the
  windowed goodput and burn rates per label set.
- ``POST /admin/drain`` — graceful shutdown (also SIGTERM): admission
  answers 429, in-flight requests finish within ``serve.drain_timeout``,
  telemetry flushes and the server stops; 202 at once.
- ``POST /admin/reload`` — live weight hot-swap from ``{"checkpoint":
  path?}`` (default: the serving run directory's newest step): 200 when
  it committed, 409 when the probe rolled it back or the checkpoint is
  corrupt. ``serve.watch_checkpoints`` > 0 polls ``LATEST`` and reloads
  on its own.

The serve watchdog: ``serve.stall_timeout`` > 0 builds a
:class:`~trlx_tpu_torch.supervisor.RunSupervisor` with ``stall_action:
abort`` that the decode worker enters; a hung step dumps every thread's
stack and the flight recorder (``add_dump_fn``) and, past the grace,
exits 70 so a supervisor restarts the replica. The dump, ``/readyz``
and the ``/debug`` routes read host state only, never a CUDA tensor.
Replay recovers exceptions raised on the host around a step; a sticky
CUDA error poisons the context, so that process exits 70 as well
(trlx_tpu_torch.serve.slots). ``/generate`` runs through
``bounded_call`` (``serve.request_timeout``), and the ``serve_request``
chaos seam fires at its entry. SIGTERM only sets an event; the
``serve_forever`` loop starts the drain and returns, so the process
exits 0.

On a serve mesh (``serve.mesh``) the server runs on process 0 only: its
scheduler (either one) publishes every device call to the other
processes (trlx_tpu_torch.serve.follower), ``/admin/reload`` has each of
them restore its own slices of the checkpoint, and the scheduler's stop
ends their loops, so they exit 0 too: at the end of a drain (``POST
/admin/drain`` or SIGTERM), at :meth:`InferenceServer.stop`, and when
the serve watchdog aborts, which sends the stop (bounded by
:data:`ABORT_STOP_TIMEOUT`) before it exits 70. ``/metrics`` carries
``serve/mesh_devices`` and ``serve/params_gb_per_device``.
"""

import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    DrainTimeout,
    MicroBatcher,
    QueueFull,
    QuotaExceeded,
    ReplayExhausted,
)
from trlx_tpu_torch.serve.slots import SlotScheduler
from trlx_tpu_torch.serve.trace import SLO_COUNTERS, RequestTrace, slo_engine
from trlx_tpu_torch.supervisor import (
    RunSupervisor,
    SeamTimeout,
    bounded_call,
    chaos,
    monotonic,
)
from trlx_tpu_torch.utils.checkpoint import CheckpointCorrupt

#: seconds the watchdog's abort waits for the serve mesh's stop to go out
ABORT_STOP_TIMEOUT = 5.0

#: how the watchdog's abort ends the process (tests replace it)
_exit = os._exit

#: counters registered when a server starts, so the ``serve/*`` series
#: exist in /metrics from the first scrape, not the first event
_SERVE_COUNTERS = (
    "serve/requests",
    "serve/responses",
    "serve/batches",
    "serve/rejected",
    "serve/request_errors",
    "serve/generated_tokens",
    "serve/admissions",
    "serve/evictions",
    "serve/preempted_steps",
    "serve/prefix_tokens_saved",
    "serve/evicted_pages",
    # the slot scheduler's prefill padding: positions run vs needed
    "serve/prefill_positions",
    "serve/prefill_tokens_needed",
    # the crash-only lifecycle: replays, deadline sheds, drains, swaps
    "serve/replays",
    "serve/shed_expired",
    "serve/drains",
    "serve/reloads",
    "serve/reload_failures",
    "serve/hop_limit_rejects",
    # overload containment (the tenant-labeled twins appear on first
    # increment: labels cannot be predeclared)
    "serve/shed_quota",
    "serve/brownout_clamped",
    "serve/brownout_entries",
    "serve/spec_proposed",
    "serve/spec_accepted",
    "serve/spec_steps_saved",
    "serve/spec_fallbacks",
)

#: proxy-hop ceiling: any sane fleet is 1-2 hops deep (client -> router
#: -> replica); past this the request is looping, not routing
MAX_HOPS = 8


class HopLimitExceeded(RuntimeError):
    """Inbound ``X-Hop-Count`` above :data:`MAX_HOPS` — a proxy loop,
    mapped to 508 Loop Detected at the HTTP edge."""


class _Handler(BaseHTTPRequestHandler):
    # set per server via type(); silences the default per-request log
    server_ref: "InferenceServer" = None

    def log_message(self, format, *args):  # noqa: A002 (stdlib signature)
        return

    def _json(self, code: int, payload: dict, headers=None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _text(self, code: int, body: str, content_type: str) -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"error": message})

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        srv = self.server_ref
        if self.path == "/healthz":
            code, body = srv.healthz()
        elif self.path == "/metrics":
            accept = (self.headers.get("Accept", "") or "").lower()
            if any(k in accept for k in ("text/plain", "openmetrics",
                                         "prometheus")):
                from trlx_tpu_torch.telemetry.prometheus import CONTENT_TYPE

                self._text(200, telemetry.prometheus_text(), CONTENT_TYPE)
                return
            code, body = 200, telemetry.summary()
        elif self.path == "/readyz":
            code, body = srv.readyz()
        elif self.path == "/debug/state":
            code, body = 200, srv.debug_state()
        elif self.path == "/debug/slo":
            code, body = 200, srv.debug_slo()
        else:
            code, body = 404, {"error": (
                f"no route '{self.path}' (have /generate, /admin/drain, "
                f"/admin/reload [POST], /healthz, /readyz, /metrics, "
                f"/debug/state, /debug/slo)")}
        self._json(code, body)

    def do_POST(self) -> None:  # noqa: N802 (stdlib casing)
        srv = self.server_ref
        # the trace clock starts at the edge, before the body is read
        received_at = monotonic()
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"bad JSON body: {e}")
            return
        if self.path == "/generate":
            code, payload, headers = srv.http_generate(
                body, dict(self.headers.items()), received_at)
            self._json(code, payload, headers=headers)
        elif self.path == "/admin/drain":
            code, payload = srv.http_drain()
            self._json(code, payload)
        elif self.path == "/admin/reload":
            code, payload = srv.http_reload(body)
            self._json(code, payload)
        else:
            self._error(404, f"no POST route '{self.path}' (have "
                             f"/generate, /admin/drain, /admin/reload)")


class InferenceServer:
    """Engine + decode driver + serve watchdog + HTTP listener, one
    object.

    The driver is picked by ``serve.scheduler``: ``"slots"`` (default)
    the continuous-batching :class:`SlotScheduler`, ``"static"`` the
    batch-to-completion :class:`MicroBatcher`. ``start()`` warms the
    driver (unless ``warmup=False``), starts its worker (which enters the
    watchdog when ``serve.stall_timeout`` > 0), the checkpoint watcher
    and the HTTP thread; ``stop()`` tears them down. Usable in-process
    (tests pass ``port=0`` and read ``server.port``, or call the route
    methods directly) or via ``python -m trlx_tpu_torch.serve``.
    """

    def __init__(self, engine, host: Optional[str] = None,
                 port: Optional[int] = None):
        self.engine = engine
        cfg = engine.serve
        self.host = cfg.host if host is None else host
        self.port = cfg.port if port is None else port
        sup = None
        if cfg.stall_timeout > 0:
            # serving has no checkpoint to rescue: a stalled decode
            # escalates to exit 70 so a supervisor restarts the replica
            sup = RunSupervisor(stall_timeout=cfg.stall_timeout,
                                stall_action="abort", exit_fn=self._abort)
        self.supervisor = sup
        self.scheduler = (
            SlotScheduler(engine, run_supervisor=sup)
            if cfg.scheduler == "slots"
            else MicroBatcher(engine, run_supervisor=sup))
        dump_fn = getattr(self.scheduler, "dump_flight_recorder", None)
        if sup is not None and dump_fn is not None:
            # a stall dumps the engine-step ring beside the stack dump
            sup.add_dump_fn(dump_fn)
        self._httpd: Optional[ThreadingHTTPServer] = None  # guarded-by: _stop_lock
        self._http_thread: Optional[threading.Thread] = None  # guarded-by: _stop_lock
        self._stop_lock = threading.Lock()
        # -- crash-only lifecycle -------------------------------------- #
        self._lifecycle_lock = threading.Lock()
        self._drain_thread: Optional[threading.Thread] = None  # guarded-by: _lifecycle_lock
        # SIGTERM only sets this; serve_forever's poll loop begins the
        # drain (the handler may not take the non-reentrant lock above)
        self._drain_requested = threading.Event()
        self._drain_done = threading.Event()
        self._drain_clean = False
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None  # guarded-by: _stop_lock
        self._watch_last_tried: Optional[str] = None

    @property
    def warmed(self) -> bool:
        return self.scheduler.warmed

    @property
    def draining(self) -> bool:
        """Admission state for /readyz: True from the moment a drain was
        asked for (SIGTERM or ``POST /admin/drain``)."""
        if self._drain_requested.is_set():
            return True
        with self._lifecycle_lock:
            started = self._drain_thread is not None
        return started or bool(getattr(self.scheduler, "_draining", False))

    # -- routes (host state only: no CUDA tensor is read) ---------------- #

    def healthz(self):
        sched = self.scheduler
        body = {
            "status": "ok",
            "warmed": sched.warmed,
            "scheduler": self.engine.serve.scheduler,
            "device": str(self.engine.device),
            "buckets": [list(b) for b in self.engine.buckets],
            "queue_depth": sched.queue_depth(),
            "model_version": self.engine.model_version,
        }
        if isinstance(sched, SlotScheduler):
            body["slots"] = sched.runtime.num_slots
            body["free_slots"] = sched.free_slots()
            body["kv"] = sched.pool_stats()
        body["mesh"] = self.engine.mesh_info()
        body["recompiles"] = telemetry.summary().get(
            "counters", {}).get("compile/recompiles", 0.0)
        return 200, body

    def readyz(self):
        """200 while warmed and admitting, 503 once draining: an
        orchestrator rotates the replica out while /healthz stays 200."""
        ready = self.warmed and not self.draining
        body = {"ready": ready, "warmed": self.warmed,
                "draining": self.draining,
                "model_version": self.engine.model_version}
        pressure = getattr(self.scheduler, "pressure", None)
        if pressure is not None:
            body["pressure"] = pressure()
        return (200 if ready else 503), body

    def debug_state(self) -> dict:
        state = getattr(self.scheduler, "debug_state", None)
        if state is not None:
            return state()
        return {  # the static micro-batcher: no slot map, no recorder
            "scheduler": self.engine.serve.scheduler,
            "queue_depth": self.scheduler.queue_depth(),
            "model_version": self.engine.model_version,
            "slots": {},
            "flight_recorder": [],
            "mesh": self.engine.mesh_info(),
        }

    @staticmethod
    def debug_slo() -> dict:
        """The windowed goodput and burn rates per label set; an empty
        body when telemetry is off or nothing was scored yet."""
        tel = telemetry.current()
        slo = tel.slo if tel is not None else None
        return slo.snapshot() if slo is not None else {"series": []}

    def http_generate(self, body: dict, headers: dict,
                      received_at: Optional[float] = None):
        """``POST /generate`` as (status, payload, response headers):
        the hop limit, then :meth:`handle_generate` bounded by
        ``serve.request_timeout``, each failure mapped to trlx_tpu's
        status code."""
        headers = {k.lower(): v for k, v in headers.items()}
        try:
            hops = int(headers.get("x-hop-count") or 0)
            if hops < 0:
                raise ValueError
        except ValueError:
            return 400, {"error": "X-Hop-Count must be a non-negative "
                                  "integer"}, {}
        if hops > MAX_HOPS:
            telemetry.inc("serve/hop_limit_rejects")
            e = HopLimitExceeded(
                f"X-Hop-Count {hops} exceeds the {MAX_HOPS}-hop proxy "
                f"cap — routing loop? (a router listing itself as a "
                f"backend forwards forever)")
            return 508, {"error": str(e)}, {}
        try:
            payload = bounded_call(
                lambda: self.handle_generate(
                    body, trace_id=headers.get("x-request-id") or None,
                    received_at=received_at, hops=hops,
                    tenant=headers.get("x-tenant-id") or None),
                timeout=self.engine.serve.request_timeout,
                label="serve_request",
            )
        except QuotaExceeded as e:
            # per-TENANT admission control: Retry-After from the
            # tenant's own bucket, while other tenants are admitted
            return 429, {"error": str(e), "tenant": e.tenant}, {
                "Retry-After": str(e.retry_after_s)}
        except QueueFull as e:  # queue full, or draining
            return 429, {"error": str(e)}, {
                "Retry-After": str(self.scheduler.retry_after_s())}
        except (ValueError, TypeError) as e:
            return 400, {"error": str(e)}, {}
        except (ReplayExhausted, DeadlineExceeded, DrainTimeout) as e:
            # the request is fine; the SERVICE could not finish it
            return 503, {"error": str(e)}, {}
        except (SeamTimeout, TimeoutError) as e:
            return 503, {"error": str(e)}, {}
        except Exception as e:
            telemetry.inc("serve/request_errors")
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        out_headers = {}
        if payload.get("trace_id"):
            out_headers["X-Request-Id"] = payload["trace_id"]
        if hops:
            out_headers["X-Hop-Count"] = str(hops)
        return 200, payload, out_headers

    def http_drain(self):
        self.begin_drain()
        return 202, {"draining": True,
                     "drain_timeout": self.engine.serve.drain_timeout}

    def http_reload(self, body: dict):
        """``POST /admin/reload``: 200 when the swap committed, 409 when
        it was rolled back or the checkpoint is corrupt (the old weights
        keep serving), 400 for an unusable path."""
        try:
            result = self.reload(body.get("checkpoint"))
        except (FileNotFoundError, ValueError) as e:
            return 400, {"error": str(e)}
        except CheckpointCorrupt as e:
            telemetry.inc("serve/reload_failures")
            return 409, {"reloaded": False,
                         "reason": f"checkpoint corrupt: {e}"}
        except Exception as e:
            telemetry.inc("serve/reload_failures")
            return 500, {"error": f"{type(e).__name__}: {e}"}
        return (200 if result.get("reloaded") else 409), result

    # -- request semantics ---------------------------------------------- #

    def handle_generate(self, body: dict, trace_id: Optional[str] = None,
                        received_at: Optional[float] = None, hops: int = 0,
                        tenant: Optional[str] = None) -> dict:
        """One request end to end: tokenize, submit, wait, shape the
        response. Raising is the error path (:meth:`http_generate` maps
        exception types to status codes); direct callers may omit the
        edge's arguments (the scheduler then mints the trace and charges
        the default tenant)."""
        chaos.maybe_inject("serve_request")
        if tenant is None and body.get("tenant") is not None:
            tenant = str(body["tenant"])
        if "tokens" in body:
            tokens = [int(t) for t in body["tokens"]]
        elif "prompt" in body:
            tokens = self.engine.encode_prompt(str(body["prompt"]))
        else:
            raise ValueError("body needs 'prompt' (string) or 'tokens' "
                             "(token-id list)")
        seed = body.get("seed")
        deadline_ms = body.get("deadline_ms")
        priority = body.get("priority")
        trace = None
        if self.engine.serve.request_tracing:
            trace = RequestTrace(trace_id=trace_id, received=received_at)
        req = self.scheduler.submit(
            tokens, max_new_tokens=body.get("max_new_tokens"),
            seed=None if seed is None else int(seed), trace=trace,
            deadline_ms=None if deadline_ms is None else float(deadline_ms),
            priority=None if priority is None else int(priority),
            tenant=tenant,
        )
        req.wait()  # bounded by the caller's bounded_call
        payload = {
            "tokens": req.result,
            "text": self.engine.tokenizer.decode(
                req.result, skip_special_tokens=True),
            "bucket": list(req.shape),
            "latency_ms": round(req.latency_s * 1000.0, 3),
            "queue_depth": self.scheduler.queue_depth(),
            "model_version": req.model_version,
        }
        if req.degraded:
            payload["degraded"] = True  # brownout clamped max_new_tokens
        if req.trace is not None:
            req.trace.responded = monotonic()
            payload["trace_id"] = req.trace.trace_id
            if body.get("trace"):
                payload["trace"] = req.trace.to_dict()
                if hops:
                    payload["trace"]["hops"] = hops
        return payload

    # -- graceful drain ------------------------------------------------- #

    def begin_drain(self) -> None:
        """Start a graceful drain without blocking the caller: admission
        answers 429 at once; a background thread finishes the in-flight
        work, flushes telemetry and stops the server. Idempotent."""
        with self._lifecycle_lock:
            if self._drain_thread is not None:
                return
            self._drain_thread = threading.Thread(
                target=self._do_drain, name="trlx-torch-serve-drain",
                daemon=True)
            self._drain_thread.start()

    def _do_drain(self) -> None:
        try:
            self._drain_clean = self.scheduler.drain()
        finally:
            self._watch_stop.set()
            try:
                tel = telemetry.current()
                if tel is not None:
                    tel.write()  # the post-mortem keeps its metrics
            except Exception as e:
                print(f"[trlx_tpu_torch.serve] telemetry flush failed "
                      f"during drain: {e!r}", file=sys.stderr, flush=True)
            self.stop()
            print(f"[trlx_tpu_torch.serve] drained "
                  f"({'clean' if self._drain_clean else 'deadline hit'})",
                  file=sys.stderr, flush=True)
            self._drain_done.set()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Blocking drain for in-process callers: begin, then wait.
        Returns True when everything in flight finished."""
        self.begin_drain()
        budget = timeout if timeout is not None \
            else self.engine.serve.drain_timeout + 30.0
        self._drain_done.wait(timeout=budget)
        return self._drain_clean

    # -- live weight hot-swap ------------------------------------------- #

    def reload(self, checkpoint: Optional[str] = None) -> dict:
        """Hot-swap the serving weights from ``checkpoint`` (a checkpoint
        directory, or a run directory whose newest step is taken;
        default: the run directory this engine was built from). The
        scheduler runs the swap protocol (step-boundary install, probe,
        rollback); FileNotFoundError / ValueError for unusable paths
        (HTTP 400)."""
        if checkpoint is None:
            if self.engine.checkpoint_path is None:
                raise ValueError(
                    "no default checkpoint to reload: the engine was not "
                    "built from one — name one in the request body "
                    '({"checkpoint": "..."})')
            checkpoint = os.path.dirname(self.engine.checkpoint_path)
        params, resolved = self.engine.load_params(checkpoint)
        result = self.scheduler.request_swap(params, label=resolved)
        del params
        result["checkpoint"] = resolved
        if result.get("reloaded"):
            print(f"[trlx_tpu_torch.serve] hot-swapped to {resolved} "
                  f"(model_version {result['model_version']})",
                  file=sys.stderr, flush=True)
        else:
            print(f"[trlx_tpu_torch.serve] reload REJECTED ({resolved}): "
                  f"{result.get('reason')}", file=sys.stderr, flush=True)
        return result

    def _watch_loop(self) -> None:
        """``serve.watch_checkpoints``: re-resolve the run directory's
        newest step every interval and hot-swap when it moves. A step
        that failed is not retried until ``LATEST`` moves again."""
        from trlx_tpu_torch.utils.checkpoint import find_latest_checkpoint

        interval = float(self.engine.serve.watch_checkpoints)
        run_dir = os.path.dirname(self.engine.checkpoint_path)
        while not self._watch_stop.wait(interval):
            if self.draining:
                return
            try:
                latest = find_latest_checkpoint(run_dir)
            except OSError as e:
                print(f"[trlx_tpu_torch.serve] checkpoint watch: {e!r}",
                      file=sys.stderr, flush=True)
                continue
            if latest is None or latest == self.engine.checkpoint_path \
                    or latest == self._watch_last_tried:
                continue
            self._watch_last_tried = latest
            try:
                self.reload(latest)
            except Exception as e:
                telemetry.inc("serve/reload_failures")
                print(f"[trlx_tpu_torch.serve] watched reload of {latest} "
                      f"failed: {e!r}", file=sys.stderr, flush=True)

    # -- lifecycle ------------------------------------------------------ #

    def start(self, warmup: bool = True) -> "InferenceServer":
        telemetry.predeclare(_SERVE_COUNTERS)
        serve = self.engine.serve
        if serve.request_tracing:
            telemetry.predeclare(SLO_COUNTERS)
            telemetry.set_gauge("serve/goodput", 0.0)
            # the windowed SLO objective, scored from the first request
            slo_engine(target=serve.slo_target)
        cache = getattr(self.scheduler, "cache", None)
        if isinstance(self.scheduler, SlotScheduler):
            telemetry.set_gauge("serve/slot_occupancy", 0.0)
        if cache is not None:
            telemetry.set_gauge("serve/pages_free", cache.free_pages())
            telemetry.set_gauge("serve/prefix_hit_rate", 0.0)
        telemetry.set_gauge("serve/model_version", self.engine.model_version)
        # the serve-mesh capacity gauges (also set at construction)
        mesh = self.engine.mesh_info()
        telemetry.set_gauge("serve/mesh_devices", mesh["devices"])
        telemetry.set_gauge("serve/params_gb_per_device",
                            mesh["params_gb_per_device"])
        if warmup and not self.warmed:
            for name, secs in self.scheduler.warmup().items():
                print(f"[trlx_tpu_torch.serve] warmed {name}: {secs:.3f}s "
                      f"first call (with its graph capture on the card)",
                      file=sys.stderr, flush=True)
        self.scheduler.start()
        if serve.watch_checkpoints > 0 and self._watch_thread is None:
            if self.engine.checkpoint_path is None:
                print("[trlx_tpu_torch.serve] serve.watch_checkpoints set "
                      "but the engine was not built from a checkpoint; "
                      "nothing to watch", file=sys.stderr, flush=True)
            else:
                self._watch_stop.clear()
                watch = threading.Thread(
                    target=self._watch_loop, name="trlx-torch-serve-watch",
                    daemon=True)
                with self._stop_lock:
                    self._watch_thread = watch
                watch.start()
        handler = type("Handler", (_Handler,), {"server_ref": self})
        httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = httpd.server_address[1]  # resolve port=0
        http_thread = threading.Thread(
            target=httpd.serve_forever, name="trlx-torch-serve-http",
            daemon=True,
        )
        with self._stop_lock:
            self._httpd = httpd
            self._http_thread = http_thread
        http_thread.start()
        print(f"[trlx_tpu_torch.serve] listening on http://{self.host}:"
              f"{self.port} on {self.engine.device} (buckets "
              f"{[list(b) for b in self.engine.buckets]})",
              file=sys.stderr, flush=True)
        return self

    def stop(self) -> None:
        """Idempotent and thread-safe (the drain thread's stop and the
        owner's may race): the watcher, the listener, the scheduler."""
        self._watch_stop.set()
        with self._stop_lock:
            watch, self._watch_thread = self._watch_thread, None
            httpd, self._httpd = self._httpd, None
            http_thread, self._http_thread = self._http_thread, None
        if watch is not None and watch is not threading.current_thread():
            watch.join(timeout=5.0)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if http_thread is not None:
            http_thread.join(timeout=5.0)
        # final: a handler still running past the listener's shutdown
        # gets an error, not a queue slot no worker will serve
        self.scheduler.stop(final=True)

    def _abort(self, code: int) -> None:
        """The serve watchdog's escalation: end the followers' loops on a
        serve mesh (a stall before a publish leaves them waiting for the
        next call), bounded, since a follower stuck in the hung step
        never receives it; then exit with ``code``."""
        try:
            bounded_call(self.engine.close, ABORT_STOP_TIMEOUT,
                         label="serve_mesh_stop")
        except Exception as e:
            print(f"[trlx_tpu_torch.serve] could not stop the serve mesh's "
                  f"followers before the abort: {e!r}", file=sys.stderr,
                  flush=True)
        _exit(code)

    def _on_sigterm(self, signum, frame) -> None:
        # runs between bytecodes of whatever frame the signal
        # interrupted: Event.set() only (begin_drain takes a
        # non-reentrant lock and builds a thread)
        self._drain_requested.set()

    def serve_forever(self) -> None:
        """Block until the server drains (the CLI's tail). SIGTERM and
        Ctrl-C both begin a graceful drain, and this returns normally,
        so the process exits 0."""
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError as e:  # not the main thread
            print(f"[trlx_tpu_torch.serve] SIGTERM handler not installed: "
                  f"{e}", file=sys.stderr, flush=True)
        try:
            while not self._drain_done.wait(timeout=1.0):
                if self._drain_requested.is_set():
                    print("[trlx_tpu_torch.serve] SIGTERM: beginning "
                          "graceful drain", file=sys.stderr, flush=True)
                    # start the drain FIRST, then clear, so `draining`
                    # never flickers off
                    self.begin_drain()
                    self._drain_requested.clear()
        except KeyboardInterrupt:
            print("[trlx_tpu_torch.serve] interrupted; beginning graceful "
                  "drain", file=sys.stderr, flush=True)
            self.begin_drain()
            self._drain_done.wait(timeout=self.engine.serve.drain_timeout
                                  + 30.0)
        finally:
            self.stop()
