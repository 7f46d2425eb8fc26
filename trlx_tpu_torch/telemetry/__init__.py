"""Unified telemetry: metrics registry + span tracer + device monitor
(port of trlx_tpu.telemetry).

One process-local session owns a :class:`MetricsRegistry` and a
:class:`SpanTracer`. The trainers start it at construction (knob
``train.telemetry``, default on; :func:`start_from_config`), the serving
engine when it starts, and every subsystem reports through the
module-level functions below: ``span()``, ``device_phase()``, ``inc()``,
``set_gauge()``, ``observe()``, ``predeclare()``, ``summary()``. Each is
a strict no-op while no session is active, so a ``telemetry: false``
run records nothing and pays one ``is None`` check per call site.

What flows where:

- per iteration, the learn loops merge ``session.tracker_stats()`` into
  the stats dict they emit: ``time/*`` (each phase's LAST duration),
  ``throughput/*``, ``fault/*`` counters, ``device/*`` memory gauges and
  ``compile/*`` first-call latencies, so every tracker carries them;
- at every ``learn()`` exit (and every ``train.telemetry_flush_every``
  iterations, and on a watchdog stall) ``session.write()`` puts
  ``<run_dir>/telemetry.json`` (the run-level summary, headline
  ``metric`` / ``value`` / ``unit`` first) and ``<run_dir>/trace.jsonl``
  (the span timeline, for Perfetto) on disk; ``finish()`` also prints a
  one-line digest to stderr.

``run_dir`` is ``train.telemetry_dir`` or, when that is unset,
``train.checkpoint_dir``, written only once that directory exists (a
checkpoint has been committed) so ad-hoc constructions scatter no
files; an explicit ``telemetry_dir`` is always created and written.
Spans time the HOST: on the card a span around an asynchronous launch
measures the enqueue, so each phase the loops time closes after its
results reach the host (tracer module docstring). A ``device_phase()``
also times the device, but only while a ``torch.profiler`` records: the
trace's events are on the profiler's clock (``SpanTracer.epoch_ns``), so
a reader sets them against the profiler's device timeline.
"""

import json
import os
import sys
from typing import Any, Dict, Optional

from trlx_tpu_torch.telemetry.device import (
    profiler_recording,
    sample_device_stats,
)
from trlx_tpu_torch.telemetry.flops import (  # noqa: F401  (re-exports)
    PEAK_FLOPS,
    decode_flops_per_token,
    ilql_train_flops_per_token,
    mfu_estimate,
    peak_flops,
    ppo_train_flops_per_token,
)
from trlx_tpu_torch.telemetry.registry import (  # noqa: F401
    MetricsRegistry,
    TimingHist,
)
from trlx_tpu_torch.telemetry.tracer import SpanTracer

#: counters registered at session start, so ``fault/*`` and the other
#: "must read 0" series appear in every emission from the first
#: iteration: a dashboard shows 0, not a missing series
PREDECLARED = (
    "fault/skipped_steps",
    "fault/rollbacks",
    "fault/divergence_aborts",
    "fault/host_retries",
    "fault/host_giveups",
    "fault/tracker_emissions_lost",
    "fault/tracker_degraded",
    "fault/preempt_sigterm",
    # the run supervisor (trlx_tpu_torch.supervisor): watchdog stalls
    # and escalations, hung-seam timeouts, walltime save-and-exits
    "fault/stalls",
    "fault/stall_escalations",
    "fault/seam_timeouts",
    "fault/walltime_exits",
    "fault/checkpoint_debris_cleared",
    "checkpoint/saves",
    "checkpoint/restores",
    "checkpoint/verified",
    "checkpoint/verify_skipped",
    "checkpoint/verify_failures",
    "checkpoint/quarantined",
    # steady-state misses of the CUDA-graph cache after warmup
    # (trlx_tpu_torch.utils.aotjit)
    "compile/recompiles",
    # chaos drills fired and span-ring overflow: the instrumentation
    # itself acted
    "chaos/injections",
    "telemetry/trace_events_dropped",
)


class TelemetrySession:
    def __init__(self, run_dir: str = "", force_dir: bool = False):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(registry=self.registry)
        self.run_dir = run_dir
        self.force_dir = force_dir
        self.headline: Optional[Dict[str, Any]] = None
        #: the serve path's windowed SLO engine, created by
        #: ``serve.trace.slo_engine()`` on first use (None until then)
        self.slo: Optional[Any] = None
        self.registry.predeclare(PREDECLARED)

    # -- per-iteration ---------------------------------------------------- #

    def tracker_stats(self) -> Dict[str, float]:
        """Flat float dict for the metrics stream: counters, gauges, last
        span durations, with the device memory gauges freshly sampled."""
        sample_device_stats(self.registry)
        return self.registry.tracker_stats()

    # -- run-level -------------------------------------------------------- #

    def set_headline(self, metric: str, value: float, unit: str) -> None:
        self.headline = {
            "metric": metric, "value": round(float(value), 3), "unit": unit,
        }

    def summary(self) -> Dict[str, Any]:
        """Run-level record: the headline first, then the registry."""
        sample_device_stats(self.registry)
        out: Dict[str, Any] = dict(self.headline or {})
        out.update(self.registry.summary())
        out["trace_events"] = len(self.tracer.events)
        return out

    def write(self) -> Optional[Dict[str, str]]:
        """``telemetry.json`` + ``trace.jsonl`` under run_dir, from the
        main process only. Returns the paths, or None when no writable
        run dir is configured (the module docstring's gate)."""
        if not self.run_dir:
            return None
        if not self.force_dir and not os.path.isdir(self.run_dir):
            return None
        from trlx_tpu_torch.utils import is_main_process

        if not is_main_process():
            return None
        os.makedirs(self.run_dir, exist_ok=True)
        summary_path = os.path.join(self.run_dir, "telemetry.json")
        tmp = f"{summary_path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.summary(), f, indent=1)
        os.replace(tmp, summary_path)
        trace_path = self.tracer.write_jsonl(
            os.path.join(self.run_dir, "trace.jsonl"))
        return {"summary": summary_path, "trace": trace_path}

    def finish(self) -> None:
        """Persist, then print the digest to stderr. Called at every
        learn() exit; a later call overwrites with the newer state."""
        paths = self.write()
        if paths is None:
            return
        counters = {k: v for k, v in self.registry.counters.items() if v}
        head = self.headline or {}
        print(
            f"[trlx_tpu_torch] telemetry: "
            f"{head.get('metric', 'run')}={head.get('value', 'n/a')} "
            f"{head.get('unit', '')}; nonzero counters {counters or '{}'}; "
            f"summary -> {paths['summary']}, trace -> {paths['trace']}",
            file=sys.stderr, flush=True,
        )


# --------------------------------------------------------------------- #
# module-level API: the one active session + no-op-when-disabled hooks
# --------------------------------------------------------------------- #

_session: Optional[TelemetrySession] = None


def start(run_dir: str = "", force_dir: bool = False) -> TelemetrySession:
    """Activate a fresh session (fresh metrics); returns it."""
    global _session
    _session = TelemetrySession(run_dir=run_dir, force_dir=force_dir)
    return _session


def start_from_config(config) -> Optional[TelemetrySession]:
    """The trainers' entry point: honour ``train.telemetry`` (default on)
    and resolve the run dir (``train.telemetry_dir``, else
    ``checkpoint_dir`` behind the exists-gate)."""
    train = getattr(config, "train", None)
    if not getattr(train, "telemetry", True):
        return None
    explicit = getattr(train, "telemetry_dir", "") or ""
    run_dir = explicit or getattr(train, "checkpoint_dir", "") or ""
    return start(run_dir=run_dir, force_dir=bool(explicit))


def stop() -> None:
    global _session
    _session = None


def current() -> Optional[TelemetrySession]:
    return _session


class _NullSpan:
    """What :func:`span` and :func:`device_phase` give without a session:
    enters to itself and records nothing (reusable and reentrant)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def end_device(self) -> None:
        pass

    def drop(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Range(_NullSpan):
    """A device phase without a session while a profiler records: its
    ``record_function`` range alone."""

    def __init__(self, name: str):
        from torch.autograd.profiler import record_function

        self.range = record_function(name)

    def __enter__(self):
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        return False


def span(name: str, **args):
    """Context manager timing one named host phase (``args`` land in its
    trace event; the body may add more with ``.set(**args)``, or record
    nothing with ``.drop()``); no-op without a session."""
    if _session is None:
        return NULL_SPAN
    return _session.tracer.span(name, args)


def device_phase(name: str, **args):
    """A device phase: :func:`span`, and while a ``torch.profiler``
    records, whoever started it, a ``record_function`` range and a pair
    of timing CUDA events whose interval becomes the span's
    ``device_ms`` (tracer module docstring). With no profiler recording
    it is exactly :func:`span`: no CUDA event, no range. The body may
    end the device part early with ``.end_device()``, before a host read
    that waits for the device. Without a session only the range remains
    (for a profiler's own timeline)."""
    if _session is not None:
        return _session.tracer.span(name, args, device=True)
    if profiler_recording():
        return _Range(name)
    return NULL_SPAN


def inc(name: str, n: float = 1.0, labels=None) -> None:
    if _session is not None:
        _session.registry.inc(name, n, labels=labels)


def predeclare(names) -> None:
    """Register counters at 0 in the active session (no-op without one):
    a subsystem that runs only in some processes (serving's ``serve/*``)
    declares its series when it starts."""
    if _session is not None:
        _session.registry.predeclare(names)


def set_gauge(name: str, value: float, labels=None) -> None:
    if _session is not None:
        _session.registry.set_gauge(name, value, labels=labels)


def observe(name: str, seconds: float, labels=None) -> None:
    if _session is not None:
        _session.registry.observe(name, seconds, labels=labels)


def summary() -> Dict[str, Any]:
    """The active session's run-level summary ({} when disabled)."""
    return _session.summary() if _session is not None else {}


def prometheus_text() -> str:
    """The active session's registry in the Prometheus text format (""
    when disabled; trlx_tpu_torch.telemetry.prometheus)."""
    if _session is None:
        return ""
    from trlx_tpu_torch.telemetry.prometheus import render

    return render(_session.registry)
