"""Stdlib HTTP endpoint over the inference engine and its decode driver
(port of trlx_tpu.serve.server, the routes of this slice): the slot
scheduler, or under ``serve.scheduler: static`` the micro-batcher; both
have the same submit / wait surface.

``ThreadingHTTPServer`` + JSON, no extra dependencies:

- ``POST /generate`` — body ``{"prompt": str | "tokens": [int],
  "max_new_tokens": int?, "seed": int?}``; returns the completion's
  tokens and text, the shape class that served it and the measured
  queue + decode latency. Errors are typed: 400 (bad request / no
  bucket fits), 429 (queue full, with ``Retry-After``), 503 (not
  decoded within ``serve.request_timeout``), 500 (decode failure).
- ``GET /healthz`` — liveness, the scheduler, lattice, queue depth and,
  under the slot scheduler, its slots, free slots and the pool's ``kv``
  block; ``recompiles`` (the
  ``compile/recompiles`` counter: 0 once warmed, the serving
  invariant).
- ``GET /metrics`` — the telemetry registry summary as JSON (counters,
  among them ``compile/recompiles`` from the first scrape, gauges,
  timing histograms with the first call kept apart; on the card a
  warmup span's first call is the graph's capture).

Not ported in this slice: ``/readyz``, ``/debug/*``, the ``/admin/*``
drain and reload routes, Prometheus text, request tracing, tenants and
the proxy hop limit.
"""

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.serve.batcher import MicroBatcher, QueueFull
from trlx_tpu_torch.serve.slots import SlotScheduler

#: counters registered when a server starts, so the ``serve/*`` series
#: exist in /metrics from the first scrape, not the first event
_SERVE_COUNTERS = (
    "serve/requests",
    "serve/responses",
    "serve/rejected",
    "serve/request_errors",
    "serve/generated_tokens",
    "serve/admissions",
    "serve/evictions",
    "serve/preempted_steps",
    "serve/prefix_tokens_saved",
    "serve/evicted_pages",
)


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

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"error": message})

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        srv = self.server_ref
        if self.path == "/healthz":
            sched = srv.scheduler
            body = {
                "status": "ok",
                "warmed": sched.warmed,
                "scheduler": srv.engine.serve.scheduler,
                "device": str(srv.engine.device),
                "buckets": [list(b) for b in srv.engine.buckets],
                "queue_depth": sched.queue_depth(),
            }
            if isinstance(sched, SlotScheduler):
                body["slots"] = sched.runtime.num_slots
                body["free_slots"] = sched.free_slots()
                body["kv"] = sched.pool_stats()
            body["recompiles"] = telemetry.summary().get(
                "counters", {}).get("compile/recompiles", 0.0)
            self._json(200, body)
        elif self.path == "/metrics":
            self._json(200, telemetry.summary())
        else:
            self._error(404, f"no route '{self.path}' (have /generate "
                             f"[POST], /healthz, /metrics)")

    def do_POST(self) -> None:  # noqa: N802 (stdlib casing)
        srv = self.server_ref
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._error(400, f"bad JSON body: {e}")
            return
        if self.path != "/generate":
            self._error(404, f"no POST route '{self.path}' (have /generate)")
            return
        try:
            payload = srv.handle_generate(body)
        except QueueFull as e:
            self._json(429, {"error": str(e)}, headers={
                "Retry-After": str(srv.scheduler.retry_after_s()),
            })
            return
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        except TimeoutError as e:
            self._error(503, str(e))
            return
        except Exception as e:
            telemetry.inc("serve/request_errors")
            self._error(500, f"{type(e).__name__}: {e}")
            return
        self._json(200, payload)


class InferenceServer:
    """Engine + decode driver + HTTP listener, one object.

    The driver is picked by ``serve.scheduler``: ``"slots"`` (default)
    the continuous-batching :class:`SlotScheduler`, ``"static"`` the
    batch-to-completion :class:`MicroBatcher`. ``start()`` warms the
    driver (unless ``warmup=False``), starts its worker and binds the
    HTTP thread; ``stop()`` tears both down. Usable in-process (tests
    pass ``port=0`` and read ``server.port``) or via ``python -m
    trlx_tpu_torch.serve``.
    """

    def __init__(self, engine, host: Optional[str] = None,
                 port: Optional[int] = None):
        self.engine = engine
        cfg = engine.serve
        self.host = cfg.host if host is None else host
        self.port = cfg.port if port is None else port
        self.scheduler = SlotScheduler(engine) if cfg.scheduler == "slots" \
            else MicroBatcher(engine)
        self._httpd: Optional[ThreadingHTTPServer] = None  # guarded-by: _stop_lock
        self._http_thread: Optional[threading.Thread] = None  # guarded-by: _stop_lock
        self._stop_lock = threading.Lock()

    @property
    def warmed(self) -> bool:
        return self.scheduler.warmed

    def handle_generate(self, body: dict) -> dict:
        """One request end to end: tokenize, submit, wait (bounded by
        ``serve.request_timeout``), shape the response."""
        if "tokens" in body:
            tokens = [int(t) for t in body["tokens"]]
        elif "prompt" in body:
            tokens = self.engine.encode_prompt(str(body["prompt"]))
        else:
            raise ValueError("body needs 'prompt' (string) or 'tokens' "
                             "(token-id list)")
        seed = body.get("seed")
        req = self.scheduler.submit(
            tokens, max_new_tokens=body.get("max_new_tokens"),
            seed=None if seed is None else int(seed),
        )
        req.wait(timeout=self.engine.serve.request_timeout)
        return {
            "tokens": req.result,
            "text": self.engine.tokenizer.decode(
                req.result, skip_special_tokens=True
            ),
            "bucket": list(req.shape),
            "latency_ms": round(req.latency_s * 1000.0, 3),
            "queue_depth": self.scheduler.queue_depth(),
        }

    def start(self, warmup: bool = True) -> "InferenceServer":
        telemetry.predeclare(_SERVE_COUNTERS)
        cache = getattr(self.scheduler, "cache", None)
        if isinstance(self.scheduler, SlotScheduler):
            telemetry.set_gauge("serve/slot_occupancy", 0.0)
        if cache is not None:
            telemetry.set_gauge("serve/pages_free", cache.free_pages())
            telemetry.set_gauge("serve/prefix_hit_rate", 0.0)
        if warmup and not self.warmed:
            for name, secs in self.scheduler.warmup().items():
                print(f"[trlx_tpu_torch.serve] warmed {name}: {secs:.3f}s "
                      f"first call (with its graph capture on the card)",
                      file=sys.stderr, flush=True)
        self.scheduler.start()
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
        """Idempotent: shut the listener, then the scheduler."""
        with self._stop_lock:
            httpd, self._httpd = self._httpd, None
            http_thread, self._http_thread = self._http_thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if http_thread is not None:
            http_thread.join(timeout=5.0)
        self.scheduler.stop()

    def serve_forever(self) -> None:
        """Block until Ctrl-C, then stop (the CLI's tail)."""
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            print("[trlx_tpu_torch.serve] interrupted; stopping",
                  file=sys.stderr, flush=True)
        finally:
            self.stop()
