"""Containment primitives for the fleet router: circuit breaker, retry
budget, latency window (copy of trlx_tpu.router.resilience).

The router's failover path retries an idempotent-safe failure on
a sibling replica — correct for a single fault, but structurally unsafe
under fleet-wide overload: every 429/503 mints a NEW request against an
already-struggling sibling, so the fleet's inbound load is multiplied by
exactly the mechanism meant to absorb faults (the classic retry-storm
metastability result; see also the Google SRE "handling overload"
chapter). These three primitives bound that amplification:

- :class:`CircuitBreaker` — per-backend request-level health, DISTINCT
  from the health prober: the prober asks ``/readyz`` every sweep, the
  breaker watches what actually happens to routed requests. A replica
  that answers probes but corrupts or 503s its responses trips the
  breaker (closed → open after ``threshold`` consecutive failures) and
  stops receiving traffic without membership churn; after ``cooldown``
  seconds one trial request is let through (half-open) and its outcome
  closes or re-opens the breaker.
- :class:`RetryBudget` — a fleet-wide token bucket from which every
  failover retry and every hedged request is paid. Under isolated
  faults the bucket stays near capacity and retries behave exactly as
  before; under correlated overload the bucket drains and further
  retries are refused (typed 503, ``router/retry_budget_exhausted``),
  capping the fleet's retry amplification at ``capacity`` outstanding
  plus ``refill_per_s`` sustained — a structural bound, not a tuning
  hope.
- :class:`LatencyWindow` — a small ring of recent request latencies
  whose p95 sets the hedging delay ("tail at scale": fire the backup
  request only after the primary has outlived the tail cutoff, so
  hedges cost ~5% extra load for a large tail-latency win).

None of these lock internally: like :class:`AffinityIndex`, instances
are owned by :class:`FleetRouter` and every access is serialized under
the router's membership lock (the ``# guarded-by`` annotations at the
owning attributes say which).

All timing flows through caller-provided ``now`` values (the router
passes ``trlx_tpu_torch.supervisor.monotonic``), keeping the state machines
deterministic under test — a breaker test advances time by argument,
not by sleeping.
"""

from typing import List, Optional


class CircuitBreaker:
    """Consecutive-failure circuit breaker for one backend.

    States: ``closed`` (traffic flows; consecutive failures counted),
    ``open`` (no traffic until ``cooldown`` elapses), ``half_open`` (one
    trial request in flight; success closes, failure re-opens).
    ``threshold <= 0`` disables the breaker (always closed).

    NOT thread-safe on its own — the router serializes access under its
    membership lock.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.state = self.CLOSED
        self.failures = 0      # consecutive request failures
        self.opened_at = 0.0   # when the breaker last opened

    def allow(self, now: float) -> bool:
        """May a request be routed here? PURE — no state transition, so
        a candidate that loses the routing pick cannot wedge in
        half-open with no trial outcome ever coming. An OPEN breaker
        whose cooldown has elapsed answers True (trial-eligible); the
        router calls :meth:`begin_trial` on the backend it actually
        picks. HALF_OPEN answers False: the one trial is in flight."""
        if self.threshold <= 0:
            return True
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            return now - self.opened_at >= self.cooldown
        return False

    def begin_trial(self, now: float) -> bool:
        """Claim the half-open trial slot (the routing pick chose this
        backend while trial-eligible). Returns True when this call made
        the open → half_open transition; no-op from any other state."""
        if self.threshold <= 0 or self.state != self.OPEN:
            return False
        if now - self.opened_at < self.cooldown:
            return False
        self.state = self.HALF_OPEN
        return True

    def record_success(self) -> bool:
        """A routed request succeeded; returns True when this closed a
        previously open/half-open breaker (metric hook)."""
        reopened = self.state != self.CLOSED
        self.state = self.CLOSED
        self.failures = 0
        return reopened and self.threshold > 0

    def record_failure(self, now: float) -> bool:
        """A routed request failed; returns True when this OPENED the
        breaker (metric hook). A half-open trial failure re-opens
        immediately — the replica gets one chance per cooldown, not a
        fresh ``threshold`` of them."""
        if self.threshold <= 0:
            return False
        self.failures += 1
        if self.state == self.HALF_OPEN or (
            self.state == self.CLOSED and self.failures >= self.threshold
        ):
            self.state = self.OPEN
            self.opened_at = now
            return True
        return False

    def reset(self) -> None:
        """Forget everything (the prober re-admitted a restarted
        replica: its process is new, its failure history is not its
        own)."""
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0


class RetryBudget:
    """Token bucket bounding fleet-wide retry amplification.

    Starts full at ``capacity`` tokens and refills continuously at
    ``refill_per_s``; each failover retry or hedged request spends one.
    ``capacity <= 0`` disables the budget (every spend granted) — the
    escape hatch for operators who want unbounded failover back.

    NOT thread-safe on its own — the router serializes access under its
    membership lock.
    """

    def __init__(self, capacity: float, refill_per_s: float):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self.tokens = self.capacity
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elapsed = max(now - self._last, 0.0)
        self._last = now
        self.tokens = min(
            self.capacity, self.tokens + elapsed * self.refill_per_s
        )

    def try_spend(self, now: float, cost: float = 1.0) -> bool:
        """Spend ``cost`` tokens if available; False means the budget is
        exhausted and the caller must NOT retry."""
        if self.capacity <= 0:
            return True
        self._refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def available(self, now: float) -> float:
        if self.capacity <= 0:
            return float("inf")
        self._refill(now)
        return self.tokens


class LatencyWindow:
    """Ring buffer of recent request latencies; p95 sets the hedge delay.

    Until ``min_samples`` latencies accumulate, :meth:`p95` returns 0.0
    and the router falls back to its configured floor — hedging from a
    cold window would fire on noise.

    NOT thread-safe on its own — the router serializes access under its
    membership lock.
    """

    def __init__(self, size: int = 128, min_samples: int = 8):
        self.size = int(size)
        self.min_samples = int(min_samples)
        self._samples: List[float] = []
        self._next = 0

    def add(self, seconds: float) -> None:
        if len(self._samples) < self.size:
            self._samples.append(float(seconds))
        else:
            self._samples[self._next] = float(seconds)
            self._next = (self._next + 1) % self.size

    def p95(self) -> float:
        if len(self._samples) < self.min_samples:
            return 0.0
        ordered = sorted(self._samples)
        idx = min(int(len(ordered) * 0.95), len(ordered) - 1)
        return ordered[idx]

    def __len__(self) -> int:
        return len(self._samples)
