"""Telemetry: one process-local session owning a metrics registry.

Stdlib copy of trlx_tpu.telemetry's module-level API cut to what the
serving slice emits: ``span()`` (a ``time/<name>`` histogram, host
wall-clock), ``inc()``, ``set_gauge()``, ``observe()``, ``predeclare()``
and ``summary()`` — strict no-ops while no session is active. Spans
time the HOST: on the card a span around an asynchronous launch
measures the enqueue, so the serve path's spans close only after the
step's results reach the host (``SlotPoolRuntime.step``).
"""

import contextlib
import time
from typing import Any, Dict, Optional

from trlx_tpu_torch.telemetry.registry import MetricsRegistry, TimingHist  # noqa: F401


#: counters registered at 0 by every session, so a scrape reads 0 rather
#: than missing the series
PREDECLARED = (
    # steady-state misses of the CUDA-graph cache after warmup
    # (trlx_tpu_torch.utils.aotjit): a signature that drifts every call
    # shows as a counter climbing with the calls, not as silence
    "compile/recompiles",
)


class TelemetrySession:
    def __init__(self):
        self.registry = MetricsRegistry()
        self.registry.predeclare(PREDECLARED)

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.registry.observe(f"time/{name}", time.perf_counter() - start)

    def summary(self) -> Dict[str, Any]:
        return self.registry.summary()


_session: Optional[TelemetrySession] = None
_NULL_CM = contextlib.nullcontext()


def start() -> TelemetrySession:
    """Activate a fresh session (fresh metrics); returns it."""
    global _session
    _session = TelemetrySession()
    return _session


def current() -> Optional[TelemetrySession]:
    return _session


def span(name: str):
    """Context manager timing one named phase; no-op without a session."""
    if _session is None:
        return _NULL_CM
    return _session.span(name)


def inc(name: str, n: float = 1.0, labels=None) -> None:
    if _session is not None:
        _session.registry.inc(name, n, labels=labels)


def predeclare(names) -> None:
    if _session is not None:
        _session.registry.predeclare(names)


def set_gauge(name: str, value: float, labels=None) -> None:
    if _session is not None:
        _session.registry.set_gauge(name, value, labels=labels)


def observe(name: str, seconds: float, labels=None) -> None:
    if _session is not None:
        _session.registry.observe(name, seconds, labels=labels)


def summary() -> Dict[str, Any]:
    """The active session's summary ({} when disabled)."""
    return _session.summary() if _session is not None else {}
