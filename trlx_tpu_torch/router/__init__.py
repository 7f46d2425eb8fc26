"""Prefix-affinity fleet router: N engine replicas behind one endpoint
(the port of trlx_tpu.router, under its names, defaults, messages, HTTP
codes and metric names).

One :class:`InferenceServer` (trlx_tpu_torch.serve) is a replica; the
ROADMAP north-star is a fleet of them, and the serve layer has exactly
the primitives a fleet needs — ``/readyz`` vs ``/healthz``, graceful drain
with ``Retry-After``, live hot-swap with ``serve/model_version``,
per-request trace metadata including ``prefix_blocks_hit``. This module
composes them into a stdlib-only front-end process
(``python -m trlx_tpu_torch.router --backends host:port,host:port``) that
spreads ``POST /generate`` over the replicas and makes the fleet
operable as one unit. Four pieces:

- **Prefix-affinity routing** (:class:`AffinityIndex`). SGLang-style
  radix caching (trlx_tpu_torch.serve.paged) only pays off fleet-wide when
  requests sharing a prefix land on the replica whose cache already
  holds it — the cache-aware-routing result the disaggregated-serving
  literature (DistServe, Splitwise) scores as goodput at a fixed SLO.
  The router keeps a host-side index over recently routed prompt blocks
  at ``page_size``-token granularity, mirroring the paged pool's block
  math (``(len - 1) // page_size`` committed blocks — the cache can
  never serve the final partial block), and routes each request to the
  replica with the longest committed-prefix match, falling back to
  least-loaded by probed queue depth. The engine's own ``"trace": true``
  payload (``prefix_blocks_hit``) is the feedback signal: a replica
  reporting fewer hits than the index predicted has evicted those pages,
  and the stale entries are decayed on the spot.
- **Health-driven membership + failover.** A prober thread walks each
  backend's ``/readyz`` (admission) and ``/debug/state`` (queue depth,
  degraded flag, model version) every ``probe_interval``; a replica
  non-ready or unreachable for ``probe_failures_threshold`` CONSECUTIVE
  sweeps is ejected from admission (debounced: one transient probe
  timeout no longer drops a healthy replica's affinity claims) and
  re-admitted on the first recovered sweep. Idempotent-safe failures —
  connection errors, truncated/malformed response bodies, 429
  (queue-full admission control), 500/502 (replica-internal failure —
  a scheduler dying mid-decode answers 500 before the socket drops),
  503 (service-level shed) — retry on a
  DIFFERENT replica, honoring a server-provided ``Retry-After``. Every
  hop stamps ``X-Request-Id`` through unchanged (one trace id joins
  router and engine logs) and increments ``X-Hop-Count`` (the engine
  rejects past ``MAX_HOPS`` with a typed 508, so a router misconfigured
  to point at itself cannot loop).
- **Defense in depth against partial failure** (trlx_tpu_torch.router
  .resilience; docs "Fault tolerance", fleet containment). Failover
  alone AMPLIFIES correlated overload — every 429/503 mints a new
  request against a struggling sibling — so three structures bound it.
  A per-backend **circuit breaker** (closed → open after
  ``breaker_threshold`` consecutive request failures → half-open trial
  after ``breaker_cooldown``) stops routing to a replica whose
  REQUESTS fail even while its ``/readyz`` still answers — membership
  (prober) and request health (breaker) are deliberately separate
  signals, and a breaker-open replica keeps its affinity claims (its
  cache is intact; its process is not restarted). A fleet-wide
  token-bucket **retry budget** (``retry_budget`` capacity,
  ``retry_budget_refill``/s) pays for every failover and every hedge;
  an empty bucket refuses the retry with a typed 503
  (``router/retry_budget_exhausted``) instead of joining a retry storm.
  Optional **hedged requests** (``hedge_after_s`` > 0): when a primary
  attempt outlives the rolling p95 of recent request latencies, one
  backup fires on a different replica and the first response wins —
  the loser is discarded WITHOUT touching affinity (only the winner's
  placement is recorded). And **response validation**: a backend
  answering 200 with a truncated or non-/generate-shaped JSON body is
  a request failure that fails over, never garbage forwarded to the
  client.
- **Multi-tenant overload containment** (docs "Fault tolerance",
  overload runbook). The router reads each request's tenant identity
  (``X-Tenant-Id`` header or ``"tenant"`` body field, ``default`` when
  absent) and stamps it onto the forwarded body so replica-side quotas
  see the same principal. ``router.tenants`` carves the retry budget
  into per-tenant token-bucket slices (``rps``/``burst``): a failover
  or hedge debits the TENANT's slice before the fleet bucket, so one
  aggressor's storm cannot drain retries for everyone (exhaustion is a
  typed 503, ``router/tenant_budget_exhausted{tenant=...}``). The
  prober also ingests each replica's published ``pressure`` block
  (``/readyz``): while at least ``shed_pressure_threshold`` of the
  admitting fleet reports pressure (degraded or brownout), best-effort
  tenants (``priority <= 0``) are shed AT THE ROUTER — a cheap local
  429 + Retry-After (``router/shed_pressure{tenant=...}``) that adds
  zero load to saturated backends. Terminal 429/503 answers always
  carry ``Retry-After`` (the upstream's own pacing when it gave one).
- **Rolling checkpoint upgrades** (``POST /admin/rollout``). One replica
  at a time: fence it from routing (the engine's own ``/admin/drain`` is
  process-terminal by crash-only design, so the router drains at the
  ROUTING layer — stop sending, wait for its in-flight work to finish),
  ``POST /admin/reload`` the new checkpoint, poll ``/readyz`` until the
  smoke-probed swap reports the new ``model_version``, re-admit. A
  failed probe (``serve/reload_failures`` engine-side) re-admits the
  replica on its OLD weights and aborts the rollout — the fleet never
  drops below N-1 admitting replicas, and ``router/fleet_model_version``
  converges to the new version on success.
- **Fleet observability + degradation-aware admission.** A ``router/*``
  metric family (predeclared, docs "Observability") on the router's own
  ``/metrics`` — JSON summary or Prometheus text exposition via the same
  content negotiation as the engines — plus a fleet ``/healthz`` with
  per-backend state. Every request also builds a STITCHED fleet trace
  (trlx_tpu_torch.router.obs): the router's own pick/hedge/failover/breaker
  event timeline merged with the winning replica's ``trace`` payload
  under one ``X-Request-Id``, served from a bounded ring at
  ``GET /debug/trace/<id>`` and sampled into a rotated ``access.jsonl``
  (tail-based always-capture for SLO-breach/error/hedge/failover;
  ``python -m trlx_tpu_torch.obs`` reads it). Windowed per-backend goodput +
  burn-rate gauges (``slo/*``, serve.trace.SloEngine) live at
  ``GET /debug/slo``. A backend advertising the degraded-mode signal
  (``serve.degrade_step_ms``) has its share halved in the least-loaded
  fallback (its effective queue depth doubles), so a sick replica sheds
  load before it stalls.

The router is host-side stdlib only — ``ThreadingHTTPServer`` in front,
``urllib.request`` toward the backends (every outbound call carries an
explicit timeout), no device code anywhere — and runs under the
supervisor watchdog with its own chaos seams (``router_route`` /
``router_probe`` / ``router_rollout`` / ``router_hedge``,
KNOWN_SEAMS). All timing is ``trlx_tpu_torch.supervisor.monotonic``.
"""

import contextlib
import http.client
import json
import queue
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.router.obs import FleetTrace, RouterObs
from trlx_tpu_torch.router.resilience import (
    CircuitBreaker,
    LatencyWindow,
    RetryBudget,
)
from trlx_tpu_torch.serve.trace import new_trace_id, slo_engine
from trlx_tpu_torch.supervisor import RunSupervisor, chaos, monotonic

#: the router/* counter family, predeclared at start() so a scrape sees
#: zeros, not gaps (docs "Observability")
_ROUTER_COUNTERS = (
    "router/requests",
    "router/responses",
    "router/request_errors",
    "router/affinity_hits",
    "router/affinity_misses",
    "router/affinity_decays",
    "router/failovers",
    "router/ejections",
    "router/readmissions",
    "router/rollouts",
    "router/rollout_steps",
    "router/rollout_aborts",
    # defense-in-depth family (module docstring; docs "Fault tolerance")
    "router/breaker_opens",
    "router/breaker_half_opens",
    "router/breaker_closes",
    "router/retry_budget_spent",
    "router/retry_budget_exhausted",
    "router/hedges",
    "router/hedge_wins",
    "router/hedges_suppressed",
    "router/response_invalid",
    # overload-containment family (docs "Fault tolerance"): sheds taken
    # at the router's edge from published backend pressure, and spends
    # refused by a PER-TENANT slice of the retry budget
    "router/shed_pressure",
    "router/tenant_budget_exhausted",
)


class NoBackendAvailable(RuntimeError):
    """Every replica is ejected, rolling, or already tried — the fleet
    cannot admit this request (HTTP 503 at the router's edge)."""


class _UpstreamRetryable(RuntimeError):
    """A backend answered 429/503 (idempotent-safe service-level
    failure), was unreachable, or returned a torn/malformed body;
    carries the server-provided pacing so the failover loop can honor
    its ``Retry-After`` instead of pure jitter."""

    def __init__(self, message: str, status: int = 0,
                 retry_after_s: Optional[float] = None,
                 payload: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s
        self.payload = payload or {"error": message}


@dataclass
class RouterConfig:
    """Fleet-router knobs (the ``router:`` YAML section; CLI flags win).

    ``page_size`` must match the backends' ``serve.page_size`` — it is
    the affinity index's block granularity, and a mismatch silently
    degrades routing to least-loaded (the index still works, its block
    boundaries just stop lining up with the replicas' radix caches).
    """

    backends: List[str] = field(default_factory=list)
    host: str = "127.0.0.1"
    port: int = 8090
    #: affinity-block granularity in tokens (mirror serve.page_size)
    page_size: int = 64
    #: LRU cap on affinity prefix entries (block-chain prefixes)
    affinity_entries: int = 4096
    #: health-prober sweep period / per-probe HTTP timeout (seconds)
    probe_interval: float = 0.5
    probe_timeout: float = 5.0
    #: per-forward HTTP timeout toward a backend (seconds)
    request_timeout: float = 120.0
    #: extra replicas tried after an idempotent-safe failure
    failover_retries: int = 1
    #: jitter floor between failover attempts when the backend gave no
    #: Retry-After (seconds)
    failover_backoff: float = 0.05
    #: per-replica budget for one rollout step: routing-layer drain +
    #: reload + readiness probe (seconds)
    rollout_timeout: float = 120.0
    #: TTFT objective for router/fleet_goodput, from the forwarded trace
    #: payloads (ms; 0 = every completed request counts good)
    slo_ttft_ms: float = 500.0
    #: watchdog budget for a prober sweep (0 = watchdog off)
    stall_timeout: float = 0.0
    #: consecutive failed prober sweeps before a replica is ejected
    #: (debounce: one transient probe timeout keeps its affinity claims)
    probe_failures_threshold: int = 2
    #: consecutive REQUEST failures that open a backend's circuit
    #: breaker (0 disables breakers)
    breaker_threshold: int = 3
    #: seconds an open breaker waits before admitting one half-open
    #: trial request
    breaker_cooldown: float = 3.0
    #: fleet-wide retry-budget token-bucket capacity: failovers AND
    #: hedges each spend one token (0 = unlimited, unbounded failover)
    retry_budget: float = 16.0
    #: retry-budget sustained refill rate (tokens per second)
    retry_budget_refill: float = 2.0
    #: hedging floor in seconds: 0 disables hedging; > 0 fires a backup
    #: request on a second replica after max(floor, rolling p95 of
    #: recent request latencies) — first response wins
    hedge_after_s: float = 0.0
    #: stitched-trace ring capacity behind ``GET /debug/trace/<id>``
    #: (trlx_tpu_torch.router.obs; 0 disables per-request fleet tracing)
    trace_ring: int = 256
    #: path for the sampled access log of stitched traces ("" disables)
    access_log: str = ""
    #: write every Nth healthy request to the access log (1 = all);
    #: tail captures (SLO breach / error / hedge / failover) always land
    access_log_sample: int = 20
    #: access-log rotation budget in MB (renamed to ``<path>.1`` over it)
    access_log_max_mb: float = 64.0
    #: goodput objective the windowed SLO engine scores burn rates
    #: against (slo/burn_rate_* gauges; docs "Observability", runbook)
    slo_target: float = 0.99
    #: per-tenant retry-budget slices: ``{name: {rps, burst, priority}}``.
    #: ``rps``/``burst`` bound THAT tenant's failover+hedge spend (its
    #: own token bucket, debited before the fleet-wide budget, so one
    #: aggressor cannot monopolize retries); ``priority <= 0`` marks the
    #: tenant best-effort for pressure shedding. A ``default`` entry
    #: governs requests with no tenant id and unknown tenants alike.
    #: None disables both mechanisms (single-tenant behavior).
    tenants: Optional[Dict[str, Any]] = None
    #: shed best-effort tenants at the router's edge when at least this
    #: fraction of admitting replicas publish pressure (degraded or in
    #: brownout) on /readyz — a cheap local 429 + Retry-After instead of
    #: forwarding into a saturated fleet (<= 0 disables; 1.0 = only when
    #: EVERY admitting replica is pressured)
    shed_pressure_threshold: float = 1.0

    def __post_init__(self):
        if not self.backends:
            raise ValueError(
                "router.backends must name at least one replica "
                "(host:port[,host:port...])"
            )
        if self.page_size < 1:
            raise ValueError("router.page_size must be >= 1 token")
        if self.probe_interval <= 0:
            raise ValueError("router.probe_interval must be > 0 seconds")
        if self.failover_retries < 0:
            raise ValueError("router.failover_retries must be >= 0")
        if self.probe_failures_threshold < 1:
            raise ValueError(
                "router.probe_failures_threshold must be >= 1 sweep"
            )
        if self.breaker_threshold > 0 and self.breaker_cooldown <= 0:
            raise ValueError(
                "router.breaker_cooldown must be > 0 seconds when "
                "breakers are enabled (breaker_threshold > 0)"
            )
        if self.retry_budget > 0 and self.retry_budget_refill < 0:
            raise ValueError(
                "router.retry_budget_refill must be >= 0 tokens/s"
            )
        if self.hedge_after_s < 0:
            raise ValueError(
                "router.hedge_after_s must be >= 0 seconds (0 disables "
                "hedging)"
            )
        if self.trace_ring < 0:
            raise ValueError(
                "router.trace_ring must be >= 0 traces (0 disables "
                "stitched tracing)"
            )
        if self.access_log_sample < 1:
            raise ValueError(
                "router.access_log_sample must be >= 1 (1 = every "
                "request)"
            )
        if self.access_log_max_mb <= 0:
            raise ValueError(
                "router.access_log_max_mb must be > 0 MB"
            )
        if not 0.0 <= self.slo_target < 1.0:
            raise ValueError(
                f"router.slo_target={self.slo_target} must be in "
                f"[0, 1) — 1.0 leaves no error budget to burn"
            )
        if self.shed_pressure_threshold > 1.0:
            raise ValueError(
                f"router.shed_pressure_threshold="
                f"{self.shed_pressure_threshold} is a fraction of "
                f"admitting replicas — must be <= 1.0 (<= 0 disables)"
            )
        for name, spec in (self.tenants or {}).items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"router.tenants['{name}'] must be a mapping, got "
                    f"{type(spec).__name__}"
                )
            unknown = set(spec) - {"rps", "burst", "priority"}
            if unknown:
                raise ValueError(
                    f"router.tenants['{name}']: unknown key(s) "
                    f"{sorted(unknown)} (known: burst, priority, rps)"
                )

    @classmethod
    def from_dict(cls, config: Optional[dict]) -> "RouterConfig":
        from trlx_tpu_torch.data.method_configs import filter_known_fields

        return cls(**filter_known_fields(cls, config or {}))


class AffinityIndex:
    """Host-side index over recently routed prompt blocks.

    Flat map from block-chain prefixes (tuples of ``page_size``-token
    block tuples) to the replica that last served a prompt through that
    chain. The block math mirrors trlx_tpu_torch.serve.paged.RadixCache: a
    prompt of L tokens commits ``(L - 1) // page_size`` full blocks (the
    final partial block is never cacheable). Matching walks from the
    longest prefix down; inserting claims every prefix length for the
    routed replica (which now genuinely holds the whole chain in its
    radix cache). LRU-capped at ``max_entries``.

    NOT thread-safe on its own — the router serializes access under its
    membership lock.
    """

    def __init__(self, page_size: int, max_entries: int = 4096):
        self.page_size = int(page_size)
        self.max_entries = int(max_entries)
        #: block-chain prefix -> [backend, last-use tick]
        self._entries: Dict[Tuple, List] = {}
        self._tick = 0

    def blocks(self, tokens) -> List[Tuple]:
        """Committed-prefix blocks of ``tokens`` — same cap as the paged
        radix cache, so the index predicts what a replica CAN hit."""
        ps = self.page_size
        n_full = max((len(tokens) - 1) // ps, 0)
        return [tuple(tokens[i * ps:(i + 1) * ps]) for i in range(n_full)]

    def match(self, tokens, allow) -> Tuple[Optional[Any], int]:
        """(backend, depth) of the longest indexed prefix of ``tokens``
        owned by a backend ``allow`` accepts; (None, 0) on a miss."""
        blocks = self.blocks(tokens)
        for depth in range(len(blocks), 0, -1):
            entry = self._entries.get(tuple(blocks[:depth]))
            if entry is not None and allow(entry[0]):
                self._tick += 1
                entry[1] = self._tick
                return entry[0], depth
        return None, 0

    def insert(self, tokens, backend) -> int:
        """Claim every committed-prefix length of ``tokens`` for
        ``backend``; returns the number of blocks indexed."""
        blocks = self.blocks(tokens)
        for depth in range(1, len(blocks) + 1):
            self._tick += 1
            self._entries[tuple(blocks[:depth])] = [backend, self._tick]
        if len(self._entries) > self.max_entries:
            self._evict()
        return len(blocks)

    def decay(self, tokens, backend, reported_blocks: int,
              predicted_blocks: int) -> int:
        """Feedback from the replica's trace payload: it hit only
        ``reported_blocks`` of the ``predicted_blocks`` the index
        promised, so the deeper entries are stale (the replica evicted
        those pages under pressure) — drop them. Returns entries
        dropped."""
        dropped = 0
        blocks = self.blocks(tokens)
        hi = min(predicted_blocks, len(blocks))
        for depth in range(max(reported_blocks, 0) + 1, hi + 1):
            key = tuple(blocks[:depth])
            entry = self._entries.get(key)
            if entry is not None and entry[0] is backend:
                del self._entries[key]
                dropped += 1
        return dropped

    def drop_backend(self, backend) -> int:
        """Forget every entry owned by ``backend`` (its process died —
        the cache died with it). Returns entries dropped."""
        stale = [k for k, v in self._entries.items() if v[0] is backend]
        for k in stale:
            del self._entries[k]
        return len(stale)

    def _evict(self) -> None:
        """LRU: drop the oldest quarter in one pass (amortizes the scan
        instead of paying it per insert at the cap)."""
        by_age = sorted(self._entries.items(), key=lambda kv: kv[1][1])
        for k, _ in by_age[:max(len(by_age) // 4, 1)]:
            del self._entries[k]

    def __len__(self) -> int:
        return len(self._entries)


class Backend:
    """One engine replica as the router sees it. All fields — the
    breaker's internal state included — are written under the router's
    membership lock."""

    def __init__(self, spec: str, breaker: Optional[CircuitBreaker] = None):
        spec = spec.strip()
        if "//" not in spec:
            spec = "http://" + spec
        self.url = spec.rstrip("/")
        self.admitted = False     # routable (prober- and rollout-driven)
        self.ever_admitted = False  # first admission vs RE-admission
        self.rolling = False      # fenced by an in-progress rollout step
        self.queue_depth = 0
        self.degraded = False
        #: the replica's published backpressure block (/readyz
        #: "pressure"), refreshed each prober sweep — what the router's
        #: edge-shed decision reads
        self.pressure: dict = {}
        self.model_version = 0
        self.requests = 0         # requests routed here (lifetime)
        self.probe_failures = 0   # consecutive
        #: request-level health, distinct from prober membership
        self.breaker = breaker or CircuitBreaker(0, 0.0)

    def state(self) -> dict:
        return {
            "url": self.url,
            "admitted": self.admitted,
            "rolling": self.rolling,
            "queue_depth": self.queue_depth,
            "degraded": self.degraded,
            "pressure": self.pressure,
            "model_version": self.model_version,
            "requests": self.requests,
            "breaker": self.breaker.state,
        }


class _RouterHandler(BaseHTTPRequestHandler):
    router: "FleetRouter" = None  # set per-server via type()

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

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        rt = self.router
        if self.path == "/healthz":
            self._json(200, rt.fleet_state())
        elif self.path == "/readyz":
            admitting = rt.admitting_count()
            self._json(200 if admitting else 503, {
                "ready": admitting > 0,
                "admitting": admitting,
                "fleet_size": len(rt.backends),
            })
        elif self.path == "/metrics":
            accept = self.headers.get("Accept", "") or ""
            wants_text = any(
                key in accept.lower()
                for key in ("text/plain", "openmetrics", "prometheus")
            )
            if wants_text:
                from trlx_tpu_torch.telemetry import prometheus

                self._text(
                    200, telemetry.prometheus_text(), prometheus.CONTENT_TYPE
                )
            else:
                self._json(200, telemetry.summary())
        elif self.path == "/debug/trace" \
                or self.path.startswith("/debug/trace/"):
            ring = rt.obs.ring
            trace_id = self.path[len("/debug/trace"):].strip("/")
            if ring is None:
                self._json(404, {"error": "stitched tracing disabled "
                                          "(router.trace_ring = 0)"})
            elif not trace_id:
                self._json(200, {"traces": ring.ids()})
            else:
                record = ring.get(trace_id)
                if record is None:
                    self._json(404, {
                        "error": f"no stitched trace '{trace_id}' in the "
                                 f"ring (capacity {ring.capacity}; it "
                                 f"may have been evicted)"
                    })
                else:
                    self._json(200, record)
        elif self.path == "/debug/slo":
            tel = telemetry.current()
            slo = tel.slo if tel is not None else None
            self._json(200, slo.snapshot() if slo is not None
                       else {"series": []})
        else:
            self._json(404, {"error": f"no route '{self.path}' (have "
                                      f"/generate, /admin/rollout [POST], "
                                      f"/healthz, /readyz, /metrics, "
                                      f"/debug/trace[/<id>], /debug/slo)"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib casing)
        rt = self.router
        request_id = self.headers.get("X-Request-Id") or None
        try:
            hops = int(self.headers.get("X-Hop-Count") or 0)
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        if self.path == "/admin/rollout":
            result = rt.rollout(body.get("checkpoint"))
            self._json(200 if result.get("ok") else 409, result)
            return
        if self.path != "/generate":
            self._json(404, {"error": f"no POST route '{self.path}' "
                                      f"(have /generate, /admin/rollout)"})
            return
        status, payload, headers = rt.forward(
            body, trace_id=request_id, hops=hops,
            tenant=self.headers.get("X-Tenant-Id") or None,
        )
        self._json(status, payload, headers=headers)


class FleetRouter:
    """The fleet front end: affinity router + health prober + rolling
    upgrades + fleet metrics, over plain HTTP. See the module docstring
    for the design; :class:`RouterConfig` for the knobs."""

    def __init__(self, config: RouterConfig):
        self.config = config
        self.backends = [
            Backend(spec, CircuitBreaker(
                config.breaker_threshold, config.breaker_cooldown
            ))
            for spec in config.backends
        ]
        # prefix->backend placement state; the prober (drop_backend on
        # eviction), route handlers (match/insert/decay) and /fleet all
        # reach it, so every touch — reads included — goes through _lock
        self.affinity = AffinityIndex(  # guarded-by: _lock
            config.page_size, max_entries=config.affinity_entries
        )
        #: membership + affinity + goodput tallies; every Backend field
        #: write happens under it
        self._lock = threading.Lock()
        self._slo_good = 0    # guarded-by: _lock
        self._slo_total = 0   # guarded-by: _lock
        #: fleet-wide failover/hedge token bucket (module docstring)
        self._retry_budget = RetryBudget(  # guarded-by: _lock
            config.retry_budget, config.retry_budget_refill
        )
        #: per-tenant slices of the retry budget (router.tenants): each
        #: tenant's failovers/hedges debit ITS bucket before the fleet
        #: one, so one aggressor's storm cannot drain retries for
        #: everyone. Keyed by policy name — unknown tenants share the
        #: "default" entry's bucket, exactly like the engine's quotas.
        self._tenant_budgets: Dict[str, RetryBudget] = {  # guarded-by: _lock
            name: RetryBudget(
                float(spec.get("burst", 0) or 0),
                float(spec.get("rps", 0) or 0),
            )
            for name, spec in (config.tenants or {}).items()
        }
        #: rolling request latencies; p95 sets the hedge delay
        self._latency = LatencyWindow()  # guarded-by: _lock
        #: stitched per-request fleet traces: bounded ring behind
        #: GET /debug/trace/<id> + the sampled access.jsonl (router.obs)
        self.obs = RouterObs(
            trace_ring=config.trace_ring,
            access_log=config.access_log,
            access_log_sample=config.access_log_sample,
            access_log_max_bytes=int(config.access_log_max_mb
                                     * 1024 * 1024),
        )
        #: one rollout at a time; held for the whole walk
        self._rollout_lock = threading.Lock()
        self._stop = threading.Event()
        self._stop_lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None  # guarded-by: _stop_lock
        self._httpd: Optional[ThreadingHTTPServer] = None  # guarded-by: _stop_lock
        self._http_thread: Optional[threading.Thread] = None  # guarded-by: _stop_lock
        sup = None
        if config.stall_timeout > 0:
            # like serving, routing has no checkpoint to rescue: a
            # wedged prober escalates to abort so the orchestrator
            # restarts a fresh router
            sup = RunSupervisor(
                stall_timeout=config.stall_timeout, stall_action="abort"
            )
        self.supervisor = sup
        self.host = config.host
        self.port = config.port

    # -- backend HTTP client (every call carries an explicit timeout) --- #

    def _get_json(self, url: str, timeout: float) -> Tuple[int, dict]:
        req = urllib.request.Request(url, method="GET")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def _post_json(self, url: str, payload: dict, timeout: float,
                   headers: Optional[dict] = None
                   ) -> Tuple[int, dict, dict]:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), \
                    json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read() or b"{}")

    # -- membership: the prober ----------------------------------------- #

    def _probe_loop(self) -> None:
        sup_cm = self.supervisor
        if sup_cm is None:
            sup_cm = contextlib.nullcontext()
        with sup_cm:
            while not self._stop.wait(self.config.probe_interval):
                with supervisor.phase("router_probe"):
                    try:
                        self.probe_fleet()
                    except chaos.ChaosError as e:
                        # containment drill: a failed sweep leaves
                        # membership untouched — next sweep recovers
                        print(f"[trlx_tpu_torch.router] probe sweep failed: "
                              f"{e}", flush=True)

    def probe_fleet(self) -> None:
        """One prober sweep: refresh every backend's admission, queue
        depth, degraded flag, and model version; update fleet gauges."""
        chaos.maybe_inject("router_probe")
        timeout = self.config.probe_timeout
        for b in self.backends:
            ready, state = False, None
            try:
                code, body = self._get_json(b.url + "/readyz", timeout)
                ready = code == 200 and bool(body.get("ready"))
                version = int(body.get("model_version") or 0)
                _, state = self._get_json(b.url + "/debug/state", timeout)
            except (OSError, ValueError) as e:
                # unreachable / torn response: treated as not-ready; the
                # reason is logged once per transition below
                version = 0
                state = {"probe_error": f"{type(e).__name__}: {e}"}
            self._apply_probe(b, ready, version, state or {})
        self._update_fleet_gauges()

    def _apply_probe(self, b: Backend, ready: bool, version: int,
                     state: dict) -> None:
        with self._lock:
            if ready:
                b.probe_failures = 0
                b.queue_depth = int(state.get("queue_depth", b.queue_depth))
                b.degraded = bool(state.get("degraded", False))
                pressure = state.get("pressure")
                b.pressure = dict(pressure) \
                    if isinstance(pressure, dict) else {}
                if version:
                    b.model_version = version
                if not b.admitted and not b.rolling:
                    if b.ever_admitted:
                        telemetry.inc("router/readmissions")
                        # a re-admitted replica is (usually) a restarted
                        # process: its request-failure history died with
                        # it, so the breaker starts closed
                        b.breaker.reset()
                        print(f"[trlx_tpu_torch.router] re-admitted {b.url} "
                              f"(model_version {b.model_version})",
                              flush=True)
                    b.admitted = True
                    b.ever_admitted = True
            else:
                b.probe_failures += 1
                if b.admitted and b.probe_failures \
                        >= self.config.probe_failures_threshold:
                    # debounced: one transient probe timeout leaves the
                    # replica admitted and its affinity claims intact
                    b.admitted = False
                    telemetry.inc("router/ejections")
                    # its radix cache is unreachable (or gone): stop
                    # predicting hits against it
                    self.affinity.drop_backend(b)
                    print(f"[trlx_tpu_torch.router] ejected {b.url} after "
                          f"{b.probe_failures} failed sweeps "
                          f"({state.get('probe_error', 'not ready')})",
                          flush=True)

    def _update_fleet_gauges(self) -> None:
        with self._lock:
            admitted = [b for b in self.backends if b.admitted]
            versions = [b.model_version for b in admitted if b.model_version]
            telemetry.set_gauge("router/admitting", float(len(admitted)))
            telemetry.set_gauge(
                "router/breakers_open",
                float(sum(1 for b in self.backends
                          if b.breaker.state != CircuitBreaker.CLOSED)),
            )
            if self._retry_budget.capacity > 0:
                telemetry.set_gauge(
                    "router/retry_budget_tokens",
                    self._retry_budget.available(monotonic()),
                )
            telemetry.set_gauge(
                "router/degraded_backends",
                float(sum(1 for b in admitted if b.degraded)),
            )
            telemetry.set_gauge(
                "router/pressured_backends",
                float(sum(1 for b in admitted if b.pressure.get(
                    "degraded") or b.pressure.get("brownout"))),
            )
            # min over admitted replicas: the gauge CONVERGES to the new
            # version exactly when the last replica finishes its rollout
            telemetry.set_gauge(
                "router/fleet_model_version",
                float(min(versions)) if versions else 0.0,
            )

    def admitting_count(self) -> int:
        with self._lock:
            return sum(1 for b in self.backends if b.admitted)

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Block until at least one replica is admitted (tests/CLI)."""
        deadline = monotonic() + timeout
        while monotonic() < deadline:
            if self.admitting_count() > 0:
                return True
            self._stop.wait(0.05)
        return self.admitting_count() > 0

    def fleet_state(self) -> dict:
        with self._lock:
            return {
                "status": "ok",
                "fleet_size": len(self.backends),
                "admitting": sum(1 for b in self.backends if b.admitted),
                "backends": [b.state() for b in self.backends],
                "affinity_entries": len(self.affinity),
                "rollout_in_progress": self._rollout_lock.locked(),
            }

    # -- routing --------------------------------------------------------- #

    def _affinity_key(self, body: dict):
        """The sequence the affinity index blocks over: token ids when
        the client sent them, else the prompt string's characters (an
        approximation — block boundaries then track characters, not
        tokens, but shared string prefixes still cluster)."""
        if "tokens" in body:
            return [int(t) for t in body["tokens"]]
        return str(body.get("prompt", ""))

    def _pick(self, key, exclude) -> Tuple[Optional[Backend], int, str]:
        """(backend, predicted-depth, how) under the membership lock:
        longest affinity match first, else least-loaded with a degraded
        replica's share halved (its effective queue depth doubled).

        Breaker-gated: an open breaker excludes its replica exactly
        like ejection EXCEPT that affinity claims survive (the replica's
        cache is intact — only its request path is sick); the caller
        that wins the open→half-open transition carries the trial
        request whose outcome closes or re-opens the breaker."""
        with self._lock:
            now = monotonic()
            admitted = [
                b for b in self.backends
                if b.admitted and b not in exclude and b.breaker.allow(now)
            ]
            if not admitted:
                return None, 0, ""
            allowed = set(admitted)
            backend, depth = self.affinity.match(
                key, lambda b: b in allowed
            )
            how = "affinity"
            if backend is None:
                backend = min(
                    admitted,
                    key=lambda b: (
                        (b.queue_depth + 1) * (2 if b.degraded else 1),
                        b.requests,
                    ),
                )
                depth, how = 0, "least_loaded"
            if backend.breaker.begin_trial(now):
                telemetry.inc("router/breaker_half_opens")
                print(f"[trlx_tpu_torch.router] breaker half-open for "
                      f"{backend.url}: admitting one trial request",
                      flush=True)
            return backend, depth, how

    def forward(self, body: dict, trace_id: Optional[str] = None,
                hops: int = 0, tenant: Optional[str] = None
                ) -> Tuple[int, dict, dict]:
        """Route one ``/generate`` body: pick a replica, forward with
        the trace id, hop count, and tenant id stamped through, fail
        over idempotent-safe errors onto a second replica honoring its
        ``Retry-After``. Returns (status, payload, response-headers) for
        the HTTP layer; also the direct entry point for in-process
        callers (tests, bench).

        Containment (module docstring): every failover spends a
        retry-budget token — first from the TENANT's slice when
        ``router.tenants`` carves them, then from the fleet bucket; an
        empty bucket answers a typed 503 (``router/retry_budget_\
exhausted`` / ``router/tenant_budget_exhausted``) instead of
        multiplying fleet load. Best-effort tenants are shed locally
        (429 + Retry-After, ``router/shed_pressure``, nothing forwarded)
        while enough of the fleet publishes pressure; each attempt is
        breaker-gated, hedged when ``hedge_after_s`` > 0, and its
        response body validated before it reaches the client. Terminal
        429/503 answers always carry a ``Retry-After`` so every shed is
        actionable client pacing, never a dead end."""
        telemetry.inc("router/requests")
        started = monotonic()
        trace_id = trace_id or new_trace_id()
        if not tenant and body.get("tenant") is not None:
            tenant = str(body["tenant"])
        tenant = tenant or "default"
        # the stitched fleet trace for this request (router.obs): None
        # when tracing is disabled or telemetry is off, and every
        # recording site below is None-guarded
        ftrace = self.obs.begin(trace_id)
        try:
            # fired ONCE per request, before any replica is picked, so an
            # injected exc is the router's own 500 path — failover below
            # only covers real upstream failures
            chaos.maybe_inject("router_route")
        except chaos.ChaosError as e:
            telemetry.inc("router/request_errors")
            self.obs.finish(ftrace, 500,
                            error=f"{type(e).__name__}: {e}")
            return 500, {"error": f"{type(e).__name__}: {e}"}, {}
        # end-to-end backpressure: while enough of the fleet publishes
        # pressure, a best-effort tenant is answered HERE — a cheap 429
        # with the replicas' own pacing — instead of adding load to
        # saturated backends (docs "Fault tolerance", overload runbook)
        shed_after = self._shed_for_pressure(tenant)
        if shed_after is not None:
            telemetry.inc("router/shed_pressure")
            telemetry.inc("router/shed_pressure",
                          labels={"tenant": tenant})
            self.obs.finish(ftrace, 429,
                            error="shed at the router under fleet "
                                  "pressure")
            return 429, {
                "error": (
                    f"fleet under pressure: best-effort tenant "
                    f"'{tenant}' shed at the router "
                    f"(retry after {shed_after}s)"
                ),
                "tenant": tenant,
                "shed_pressure": True,
            }, {"Retry-After": str(shed_after)}
        key = self._affinity_key(body)
        # the replica's trace payload is the affinity feedback signal, so
        # the router always requests it and strips it back off below when
        # the CLIENT did not ask for it
        client_wants_trace = bool(body.get("trace"))
        fwd_body = dict(body)
        fwd_body["trace"] = True
        # tenant identity rides the forwarded body (the engine accepts
        # the "tenant" field and the X-Tenant-Id header identically), so
        # replica-side quotas see the same principal the router did
        if "tenant" not in fwd_body:
            fwd_body["tenant"] = tenant
        tried: List[Backend] = []
        failovers = 0
        while True:
            try:
                status, payload, backend, depth, how = self._attempt_hedged(
                    key, tried, fwd_body, trace_id, hops, ftrace=ftrace
                )
                break
            except NoBackendAvailable as e:
                telemetry.inc("router/request_errors")
                self.obs.finish(ftrace, 503, error=str(e))
                # pace the client at the prober cadence: membership can
                # change no faster than the next sweep
                return 503, {"error": str(e)}, {
                    "Retry-After": str(max(
                        1, int(self.config.probe_interval)
                    )),
                }
            except _UpstreamRetryable as e:
                failovers += 1
                last = tried[-1] if tried else None
                if failovers > self.config.failover_retries:
                    # out of hops: surface the LAST upstream answer (429
                    # keeps its pacing semantics; connection errors
                    # become 503)
                    telemetry.inc("router/request_errors")
                    # propagate the upstream's pacing; a backend that
                    # gave none still gets a floor — terminal 429/503
                    # answers always tell the client WHEN to come back
                    out_headers = {
                        "Retry-After": str(max(
                            1, int(e.retry_after_s or 1)
                        )),
                    }
                    self.obs.finish(
                        ftrace, e.status or 503, error=str(e),
                        backend=last.url if last else None,
                    )
                    self._slo_note(False, last)
                    return e.status or 503, e.payload, out_headers
                denied = self._spend_retry_token(
                    ftrace=ftrace, reason="failover", tenant=tenant
                )
                if denied is not None:
                    # the structural bound on retry storms: refusing
                    # beats amplifying, and the typed payload tells the
                    # client WHICH guardrail refused — its own tenant's
                    # slice or the fleet bucket — not a replica verdict
                    if denied == "tenant":
                        telemetry.inc("router/tenant_budget_exhausted")
                        telemetry.inc("router/tenant_budget_exhausted",
                                      labels={"tenant": tenant})
                        error = (
                            f"retry budget for tenant '{tenant}' "
                            f"exhausted; last failure: {e}"
                        )
                        refill = self._tenant_refill(tenant)
                    else:
                        telemetry.inc("router/retry_budget_exhausted")
                        error = (
                            f"router retry budget exhausted "
                            f"(capacity {self.config.retry_budget}, "
                            f"refill {self.config.retry_budget_refill}"
                            f"/s); last failure: {e}"
                        )
                        refill = self.config.retry_budget_refill
                    telemetry.inc("router/request_errors")
                    self.obs.finish(
                        ftrace, 503,
                        error=f"retry budget exhausted ({denied}); "
                              f"last: {e}",
                        backend=last.url if last else None,
                    )
                    self._slo_note(False, last)
                    return 503, {
                        "error": error,
                        "retry_budget_exhausted": True,
                        "tenant": tenant,
                    }, {
                        # one refill interval restores one retry token
                        "Retry-After": str(max(
                            1, int(1.0 / refill) if refill > 0 else 1
                        )),
                    }
                telemetry.inc("router/failovers")
                delay = e.retry_after_s \
                    if e.retry_after_s is not None \
                    else self.config.failover_backoff
                if ftrace is not None:
                    ftrace.event("failover", n=failovers,
                                 delay_s=round(float(delay or 0.0), 4),
                                 error=str(e))
                print(f"[trlx_tpu_torch.router] failover "
                      f"{failovers}/{self.config.failover_retries} in "
                      f"{delay:.2g}s ({e})", flush=True)
                if delay and delay > 0:
                    self._stop.wait(delay)

        self._note_routed(backend, key, depth, how, status, payload,
                          elapsed=monotonic() - started)
        telemetry.inc("router/responses")
        telemetry.observe("router/forward_time", monotonic() - started)
        self.obs.finish(
            ftrace, status, backend=backend.url,
            replica_trace=payload.get("trace")
            if isinstance(payload, dict) else None,
            slo_ttft_ms=self.config.slo_ttft_ms,
        )
        out_headers = {"X-Request-Id": payload.get("trace_id", trace_id)}
        if not client_wants_trace:
            payload.pop("trace", None)
        return status, payload, out_headers

    def _slo_note(self, ok: bool, backend: Optional[Backend]) -> None:
        """Feed the windowed per-backend SLO series (serve.trace
        SloEngine on the telemetry session) for a request that FAILED at
        the router. Successes are scored in _note_routed where the
        replica's TTFT is at hand; no-backend failures (empty fleet)
        have no series to attribute and are skipped."""
        if backend is None:
            return
        eng = slo_engine()
        if eng is not None:
            eng.record(ok, labels={"backend": backend.url})

    def _attempt_backend(self, backend: Backend, fwd_body: dict,
                         trace_id: str, hops: int,
                         ftrace: Optional[FleetTrace] = None
                         ) -> Tuple[int, dict]:
        """One request against one replica, with the full failure
        taxonomy applied: transport errors AND torn/malformed bodies
        (json/http.client failures — truncated garbage must fail over,
        never reach the client) are breaker strikes and retryable;
        429 is retryable but NOT a strike (admission control from a
        healthy replica); 500/502/503 are both — /generate is
        idempotent, so a replica failing internally (a scheduler dying
        mid-decode under a kill answers 500 before the socket goes)
        must fail over, never surface. Success records a breaker
        success. Returns (status, payload)."""
        if ftrace is not None:
            ftrace.event("attempt", backend=backend.url)
        try:
            status, headers, payload = self._post_json(
                backend.url + "/generate", fwd_body,
                timeout=self.config.request_timeout,
                headers={
                    "X-Request-Id": trace_id,
                    "X-Hop-Count": str(hops + 1),
                },
            )
        except (OSError, ValueError, http.client.HTTPException) as e:
            if ftrace is not None:
                ftrace.event("attempt_fail", backend=backend.url,
                             error=f"{type(e).__name__}: {e}")
            self._record_outcome(backend, ok=False, ftrace=ftrace)
            raise _UpstreamRetryable(
                f"{backend.url} unreachable or torn response "
                f"({type(e).__name__}: {e})"
            ) from e
        if status in (429, 500, 502, 503):
            if ftrace is not None:
                ftrace.event("attempt_fail", backend=backend.url,
                             status=status)
            if status != 429:
                self._record_outcome(backend, ok=False, ftrace=ftrace)
            retry_after = headers.get("Retry-After")
            raise _UpstreamRetryable(
                f"{backend.url} answered {status}: "
                f"{payload.get('error', '')}",
                status=status,
                retry_after_s=float(retry_after) if retry_after else None,
                payload=payload,
            )
        if status == 200 and not (
            isinstance(payload, dict) and isinstance(
                payload.get("tokens"), list
            )
        ):
            # parsed as JSON but is not a /generate response: the
            # backend (or something between) corrupted the body —
            # request failure, fail over, never forward garbage
            if ftrace is not None:
                ftrace.event("attempt_fail", backend=backend.url,
                             status=200, error="malformed /generate body")
            self._record_outcome(backend, ok=False, ftrace=ftrace)
            telemetry.inc("router/response_invalid")
            shape = sorted(payload) if isinstance(payload, dict) \
                else type(payload).__name__
            raise _UpstreamRetryable(
                f"{backend.url} answered 200 with a malformed /generate "
                f"body (got {shape}, expected a JSON object with a "
                f"'tokens' list)"
            )
        if ftrace is not None:
            ftrace.event("attempt_ok", backend=backend.url, status=status)
        self._record_outcome(backend, ok=True, ftrace=ftrace)
        return status, payload

    def _attempt_hedged(self, key, tried: List[Backend], fwd_body: dict,
                        trace_id: str, hops: int,
                        ftrace: Optional[FleetTrace] = None
                        ) -> Tuple[int, dict, Backend, int, str]:
        """One failover-loop iteration: pick a replica and attempt it,
        optionally racing a hedged backup ("tail at scale"). With
        hedging off this is a plain pick+attempt. With hedging on, a
        primary that outlives max(hedge_after_s, rolling p95) gets one
        backup on a different replica — budget-gated, chaos-seamed
        (``router_hedge``) — and the FIRST response wins; the loser is
        discarded without recording placement, so affinity only learns
        the replica that actually answered."""
        backend, depth, how = self._pick(key, exclude=tried)
        if backend is None:
            raise NoBackendAvailable(
                f"no admitting replica (fleet of {len(self.backends)}; "
                f"{len(tried)} already tried this request)"
            )
        tried.append(backend)
        if ftrace is not None:
            ftrace.event("pick", backend=backend.url, how=how,
                         depth=depth)
        delay = self._hedge_delay()
        if delay <= 0:
            status, payload = self._attempt_backend(
                backend, fwd_body, trace_id, hops, ftrace=ftrace
            )
            return status, payload, backend, depth, how

        results: "queue.Queue" = queue.Queue()

        def attempt_into(b: Backend, d: int, h: str) -> None:
            try:
                results.put(
                    (None,) + self._attempt_backend(
                        b, fwd_body, trace_id, hops, ftrace=ftrace
                    ) + (b, d, h)
                )
            except Exception as e:  # delivered, not raised: the waiter
                results.put((e, 0, None, b, d, h))  # must never strand

        threading.Thread(
            target=attempt_into, args=(backend, depth, how),
            name="trlx-router-hedge", daemon=True,
        ).start()
        in_flight = 1
        errors: List[Exception] = []
        first = self._get_result(results, delay)
        if first is not None:
            in_flight -= 1
            err, status, payload, b, d, h = first
            if err is None:
                return status, payload, b, d, h
            errors.append(err)
        hedge_b: Optional[Backend] = None
        if in_flight:
            # primary outlived the tail cutoff: fire the backup
            hedge_b, hedge_depth, _ = self._pick(key, exclude=tried)
            if hedge_b is None or self._spend_retry_token(
                    ftrace=ftrace, reason="hedge",
                    tenant=str(fwd_body.get("tenant") or "default"),
            ) is not None:
                telemetry.inc("router/hedges_suppressed")
                if ftrace is not None:
                    ftrace.event(
                        "hedge_suppressed",
                        reason="no sibling replica" if hedge_b is None
                        else "retry budget empty",
                    )
                hedge_b = None
            else:
                try:
                    chaos.maybe_inject("router_hedge")
                    tried.append(hedge_b)
                    telemetry.inc("router/hedges")
                    if ftrace is not None:
                        ftrace.event("hedge_fire", backend=hedge_b.url,
                                     depth=hedge_depth,
                                     after_s=round(delay, 4))
                    threading.Thread(
                        target=attempt_into,
                        args=(hedge_b, hedge_depth, "hedge"),
                        name="trlx-router-hedge", daemon=True,
                    ).start()
                    in_flight += 1
                except chaos.ChaosError as e:
                    telemetry.inc("router/hedges_suppressed")
                    if ftrace is not None:
                        ftrace.event("hedge_suppressed",
                                     reason=f"{type(e).__name__}: {e}")
                    hedge_b = None
                    print(f"[trlx_tpu_torch.router] hedge suppressed: {e}",
                          flush=True)
        deadline = monotonic() + self.config.request_timeout + 5.0
        while in_flight > 0:
            got = self._get_result(results, deadline - monotonic())
            if got is None:
                break  # both attempts outlived even request_timeout
            in_flight -= 1
            err, status, payload, b, d, h = got
            if err is None:
                if h == "hedge":
                    telemetry.inc("router/hedge_wins")
                    if ftrace is not None:
                        ftrace.event("hedge_win", backend=b.url)
                        ftrace.event("hedge_lose", backend=backend.url)
                elif ftrace is not None and hedge_b is not None:
                    # the primary answered first with a hedge in flight:
                    # the backup is the discarded loser
                    ftrace.event("hedge_lose", backend=hedge_b.url)
                return status, payload, b, d, h
            errors.append(err)
        for err in errors:
            if isinstance(err, _UpstreamRetryable):
                raise err
        raise _UpstreamRetryable(
            f"all hedged attempts against {[b.url for b in tried]} "
            f"failed or timed out"
            + (f": {errors[0]}" if errors else "")
        )

    @staticmethod
    def _get_result(results: "queue.Queue", timeout: float):
        """Bounded queue read (None on timeout) — the hedging race never
        blocks unboundedly."""
        if timeout <= 0:
            return None
        try:
            return results.get(timeout=timeout)
        except queue.Empty:
            return None

    def _hedge_delay(self) -> float:
        """0 when hedging is off; else max(configured floor, rolling
        p95) — the floor covers the cold window before enough latency
        samples accumulate."""
        floor = self.config.hedge_after_s
        if floor <= 0:
            return 0.0
        with self._lock:
            return max(self._latency.p95(), floor)

    def _tenant_bucket(self, tenant: str) -> Optional[RetryBudget]:
        """The retry-budget slice governing ``tenant`` — its own entry,
        else the shared ``default`` one, else None (no slices carved).
        Caller holds ``_lock``."""
        bucket = self._tenant_budgets.get(tenant)
        if bucket is None:
            bucket = self._tenant_budgets.get("default")
        return bucket

    def _tenant_refill(self, tenant: str) -> float:
        """The refill rate (tokens/s) of ``tenant``'s budget slice, for
        Retry-After math; 0 when no slice governs it."""
        with self._lock:
            bucket = self._tenant_bucket(tenant)
            return bucket.refill_per_s if bucket is not None else 0.0

    def _shed_for_pressure(self, tenant: str) -> Optional[int]:
        """Retry-After seconds when this request should be answered at
        the router's edge instead of forwarded, None to forward.

        Sheds only BEST-EFFORT tenants (router.tenants priority <= 0;
        no tenant table or no governing entry = nobody is shed), and
        only while at least ``shed_pressure_threshold`` of the admitting
        replicas publish pressure (degraded or brownout on /readyz).
        The returned pacing is the worst pressured replica's own
        ``retry_after_s`` — the fleet's estimate of when a slot frees,
        not a made-up constant. An empty fleet is NOT a shed: the
        NoBackendAvailable path answers that with better context."""
        threshold = self.config.shed_pressure_threshold
        tenants = self.config.tenants
        if threshold <= 0 or not tenants:
            return None
        spec = tenants.get(tenant)
        if spec is None:
            spec = tenants.get("default")
        if spec is None or int(spec.get("priority", 0) or 0) > 0:
            return None
        with self._lock:
            admitted = [b for b in self.backends if b.admitted]
            if not admitted:
                return None
            pressured = [
                b for b in admitted
                if b.pressure.get("degraded") or b.pressure.get("brownout")
            ]
            if len(pressured) < threshold * len(admitted):
                return None
            return max(
                1,
                max(int(b.pressure.get("retry_after_s", 1) or 1)
                    for b in pressured),
            )

    def _spend_retry_token(self, ftrace: Optional[FleetTrace] = None,
                           reason: str = "failover",
                           tenant: str = "default") -> Optional[str]:
        """Debit the retry budget for one failover or hedge: the
        tenant's slice first (when ``router.tenants`` carves them), then
        the fleet-wide bucket. Returns None when granted, else which
        bucket refused — ``"tenant"`` or ``"fleet"`` — and the caller
        must not retry."""
        with self._lock:
            now = monotonic()
            bucket = self._tenant_bucket(tenant)
            if bucket is not None and not bucket.try_spend(now):
                return "tenant"
            ok = self._retry_budget.try_spend(now)
            if self._retry_budget.capacity > 0:
                telemetry.set_gauge(
                    "router/retry_budget_tokens",
                    self._retry_budget.available(now),
                )
        if not ok:
            return "fleet"
        telemetry.inc("router/retry_budget_spent")
        telemetry.inc("router/retry_budget_spent",
                      labels={"tenant": tenant})
        if ftrace is not None:
            ftrace.event("retry_budget_spend", reason=reason,
                         tenant=tenant)
        return None

    def _record_outcome(self, backend: Backend, ok: bool,
                        ftrace: Optional[FleetTrace] = None) -> None:
        """Feed one request outcome to the backend's breaker (under the
        membership lock) and mirror the open-breaker count gauge."""
        with self._lock:
            if ok:
                if backend.breaker.record_success():
                    telemetry.inc("router/breaker_closes")
                    if ftrace is not None:
                        ftrace.event("breaker_close", backend=backend.url)
                    print(f"[trlx_tpu_torch.router] breaker CLOSED for "
                          f"{backend.url} (trial request succeeded)",
                          flush=True)
            else:
                if ftrace is not None:
                    ftrace.event("breaker_strike", backend=backend.url,
                                 failures=backend.breaker.failures + 1)
                if backend.breaker.record_failure(monotonic()):
                    telemetry.inc("router/breaker_opens")
                    if ftrace is not None:
                        ftrace.event("breaker_open", backend=backend.url)
                    print(f"[trlx_tpu_torch.router] breaker OPEN for "
                          f"{backend.url} after "
                          f"{backend.breaker.failures} consecutive "
                          f"request failures (cooldown "
                          f"{self.config.breaker_cooldown}s)", flush=True)
            telemetry.set_gauge(
                "router/breakers_open",
                float(sum(1 for b in self.backends
                          if b.breaker.state != CircuitBreaker.CLOSED)),
            )

    def _note_routed(self, backend: Backend, key, depth: int, how: str,
                     status: int, payload: dict,
                     elapsed: Optional[float] = None) -> None:
        """Post-response bookkeeping: per-backend tallies, the affinity
        insert + trace-feedback decay, hit rate, fleet goodput, and the
        latency sample feeding the hedge-delay p95. Only the WINNING
        attempt of a hedged race gets here — a discarded loser must not
        claim affinity."""
        trace = payload.get("trace") if isinstance(payload, dict) else None
        with self._lock:
            backend.requests += 1
            if elapsed is not None:
                self._latency.add(elapsed)
            if how == "affinity":
                telemetry.inc("router/affinity_hits")
            else:
                telemetry.inc("router/affinity_misses")
            if status == 200:
                predicted = self.affinity.insert(key, backend)
                if depth and isinstance(trace, dict) \
                        and "prefix_blocks_hit" in trace:
                    dropped = self.affinity.decay(
                        key, backend,
                        int(trace["prefix_blocks_hit"]),
                        min(depth, predicted),
                    )
                    if dropped:
                        telemetry.inc("router/affinity_decays", dropped)
            tel = telemetry.current()
            if tel is not None:
                hits = tel.registry.counters.get("router/affinity_hits", 0.0)
                misses = tel.registry.counters.get(
                    "router/affinity_misses", 0.0
                )
                telemetry.set_gauge(
                    "router/affinity_hit_rate",
                    hits / max(hits + misses, 1.0),
                )
            if status == 200:
                self._slo_total += 1
                slo = self.config.slo_ttft_ms
                ttft_ms = (trace or {}).get("ttft_ms")
                met_slo = slo <= 0 or ttft_ms is None or ttft_ms <= slo
                if met_slo:
                    self._slo_good += 1
                telemetry.set_gauge(
                    "router/fleet_goodput",
                    self._slo_good / max(self._slo_total, 1),
                )
                # the windowed per-backend twin of the lifetime gauge
                # (serve.trace.SloEngine -> slo/goodput_5m{backend=...})
                eng = slo_engine()
                if eng is not None:
                    eng.record(met_slo, labels={"backend": backend.url})

    # -- rolling checkpoint upgrades -------------------------------------- #

    def rollout(self, checkpoint: Optional[str] = None) -> dict:
        """Walk the fleet one replica at a time: fence from routing,
        wait for its in-flight work, ``/admin/reload``, smoke-probe
        ``/readyz``, re-admit. A failed step re-admits the replica on
        its old weights and ABORTS (the fleet keeps serving, operators
        keep a consistent version set to reason about). Never drops
        below N-1 admitting replicas."""
        if not self._rollout_lock.acquire(blocking=False):
            return {"ok": False, "reason": "a rollout is already in "
                                           "progress (one at a time)"}
        telemetry.inc("router/rollouts")
        telemetry.set_gauge("router/rollout_in_progress", 1.0)
        steps = []
        try:
            for b in list(self.backends):
                try:
                    chaos.maybe_inject("router_rollout")
                    step = self._rollout_one(b, checkpoint)
                except chaos.ChaosError as e:
                    step = {"backend": b.url, "ok": False,
                            "reason": f"{type(e).__name__}: {e}"}
                telemetry.inc("router/rollout_steps")
                steps.append(step)
                if not step["ok"]:
                    telemetry.inc("router/rollout_aborts")
                    print(f"[trlx_tpu_torch.router] rollout ABORTED at "
                          f"{b.url}: {step.get('reason')}", flush=True)
                    return {"ok": False, "aborted_at": b.url,
                            "steps": steps}
            self._update_fleet_gauges()
            print(f"[trlx_tpu_torch.router] rollout complete "
                  f"({len(steps)} replicas)", flush=True)
            return {"ok": True, "steps": steps}
        finally:
            telemetry.set_gauge("router/rollout_in_progress", 0.0)
            self._rollout_lock.release()

    def _rollout_one(self, b: Backend,
                     checkpoint: Optional[str]) -> dict:
        deadline = monotonic() + self.config.rollout_timeout
        # 1. fence: the routing-layer drain. The ENGINE's /admin/drain is
        # process-terminal (crash-only: drained replicas exit), so for an
        # in-place upgrade the router stops routing to the replica and
        # waits for its in-flight work instead.
        with self._lock:
            was_admitted, b.admitted = b.admitted, False
            b.rolling = True
        self._update_fleet_gauges()
        try:
            quiesced = self._wait_quiesced(b, deadline)
            if not quiesced:
                return {"backend": b.url, "ok": False,
                        "reason": "replica did not quiesce within "
                                  "router.rollout_timeout"}
            # 2. reload: the engine smoke-probes and rolls back itself
            # (serve/reload_failures); 409 = probe rejected the weights
            try:
                code, _, body = self._post_json(
                    b.url + "/admin/reload",
                    {"checkpoint": checkpoint} if checkpoint else {},
                    timeout=self.config.rollout_timeout,
                )
            except (OSError, ValueError) as e:
                return {"backend": b.url, "ok": False,
                        "reason": f"reload unreachable "
                                  f"({type(e).__name__}: {e})"}
            if code != 200 or not body.get("reloaded"):
                return {"backend": b.url, "ok": False,
                        "reason": body.get("reason")
                        or body.get("error")
                        or f"reload answered {code}"}
            version = int(body.get("model_version") or 0)
            # 3. smoke-probe readiness on the new version
            if not self._wait_ready_version(b, version, deadline):
                return {"backend": b.url, "ok": False,
                        "reason": f"replica not ready on model_version "
                                  f"{version} within the rollout budget"}
            with self._lock:
                b.model_version = version
            return {"backend": b.url, "ok": True,
                    "model_version": version}
        finally:
            # 4. ALWAYS re-admit (success: new weights; failure: the old
            # weights still serve — aborting must not shrink the fleet)
            with self._lock:
                b.rolling = False
                b.admitted = was_admitted or b.admitted
            self._update_fleet_gauges()

    def _wait_quiesced(self, b: Backend, deadline: float) -> bool:
        while monotonic() < deadline:
            try:
                _, state = self._get_json(
                    b.url + "/debug/state", self.config.probe_timeout
                )
            except (OSError, ValueError):
                # unreachable mid-rollout: treat as quiesced — the
                # reload call right after will surface the real failure
                return True
            if not state.get("queue_depth") and not state.get("slots"):
                return True
            if self._stop.wait(0.05):
                return False
        return False

    def _wait_ready_version(self, b: Backend, version: int,
                            deadline: float) -> bool:
        while monotonic() < deadline:
            try:
                code, body = self._get_json(
                    b.url + "/readyz", self.config.probe_timeout
                )
            except (OSError, ValueError):
                code, body = 0, {}
            if code == 200 and body.get("ready") \
                    and int(body.get("model_version") or 0) >= version:
                return True
            if self._stop.wait(0.05):
                return False
        return False

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> "FleetRouter":
        telemetry.predeclare(_ROUTER_COUNTERS)
        telemetry.set_gauge("router/fleet_size", float(len(self.backends)))
        telemetry.set_gauge("router/admitting", 0.0)
        telemetry.set_gauge("router/degraded_backends", 0.0)
        telemetry.set_gauge("router/pressured_backends", 0.0)
        telemetry.set_gauge("router/fleet_model_version", 0.0)
        telemetry.set_gauge("router/affinity_hit_rate", 0.0)
        telemetry.set_gauge("router/fleet_goodput", 0.0)
        telemetry.set_gauge("router/rollout_in_progress", 0.0)
        telemetry.set_gauge("router/breakers_open", 0.0)
        if self.config.retry_budget > 0:
            telemetry.set_gauge(
                "router/retry_budget_tokens", self.config.retry_budget
            )
        # pin the windowed-SLO objective (no-op when telemetry is off)
        slo_engine(target=self.config.slo_target)
        # one synchronous sweep so start() returns with membership known
        # (a request racing the first probe would 503 spuriously)
        self.probe_fleet()
        self._stop.clear()
        probe = threading.Thread(
            target=self._probe_loop, name="trlx-router-probe", daemon=True
        )
        handler = type("Handler", (_RouterHandler,), {"router": self})
        httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = httpd.server_address[1]  # resolve port=0
        http_thread = threading.Thread(
            target=httpd.serve_forever, name="trlx-router-http", daemon=True
        )
        with self._stop_lock:
            self._probe_thread = probe
            self._httpd = httpd
            self._http_thread = http_thread
        probe.start()
        http_thread.start()
        print(f"[trlx_tpu_torch.router] routing "
              f"http://{self.host}:{self.port} "
              f"-> {[b.url for b in self.backends]} "
              f"({self.admitting_count()}/{len(self.backends)} admitting)",
              flush=True)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._stop_lock:
            probe, self._probe_thread = self._probe_thread, None
            httpd, self._httpd = self._httpd, None
            http_thread, self._http_thread = self._http_thread, None
        if probe is not None:
            probe.join(timeout=5.0)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if http_thread is not None:
            http_thread.join(timeout=5.0)

    def serve_forever(self) -> None:
        """Block until interrupted (the CLI's tail)."""
        try:
            while not self._stop.wait(timeout=1.0):
                continue
        except KeyboardInterrupt:
            print("[trlx_tpu_torch.router] interrupted; stopping", flush=True)
        finally:
            self.stop()
