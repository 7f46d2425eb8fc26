"""Profiling hooks: a torch.profiler device trace and named step
annotations (port of trlx_tpu.utils.profiling).

- set ``TRLX_TPU_PROFILE_DIR=/path`` (or pass ``trace_dir``) and the
  learn loops run inside :func:`maybe_trace`: ``torch.profiler.profile``
  over the CPU and CUDA activities, exported as one Chrome trace
  (``trace_<pid>_<n>.json``) into that directory when the region
  closes; the counterpart of ``jax.profiler.trace``. Like it, the
  profiler holds every event of the region in host memory until the
  export, so a whole long run's trace grows with the run;
- :func:`annotate` marks host phases (``rollout``, ``reward_fn``,
  ``ppo_update``...): a telemetry device phase
  (trlx_tpu_torch.telemetry ``device_phase``) and a run supervisor phase
  (trlx_tpu_torch.supervisor). While any ``torch.profiler`` records,
  this module's or another's, the device phase also opens a
  ``torch.profiler.record_function`` range and times its device work,
  so the phase is attributable on the trace's timeline.

With no profile dir, no telemetry session and no supervisor, both
collapse to no-op context managers.
"""

import contextlib
import itertools
import os
from typing import Optional

_ENV_VAR = "TRLX_TPU_PROFILE_DIR"

_traces = itertools.count()


def trace_dir_from_env() -> Optional[str]:
    return os.environ.get(_ENV_VAR) or None


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None):
    """``torch.profiler.profile`` (CPU + CUDA activities) when a
    directory is configured (argument or ``$TRLX_TPU_PROFILE_DIR``),
    exporting its Chrome trace there on exit; a no-op otherwise."""
    trace_dir = trace_dir or trace_dir_from_env()
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{next(_traces)}.json"))


class _Stacked:
    """Enter / exit a fixed set of context managers without an
    ExitStack's allocations (this sits on the per-step path)."""

    __slots__ = ("cms",)

    def __init__(self, *cms):
        self.cms = cms

    def __enter__(self):
        for cm in self.cms:
            cm.__enter__()
        return self

    def __exit__(self, *exc):
        suppressed = False
        for cm in reversed(self.cms):
            suppressed = bool(cm.__exit__(*exc)) or suppressed
        return suppressed


def annotate(name: str):
    """A named phase: a telemetry device phase (a span; while a profiler
    records, also a ``record_function`` range and the phase's device
    time) and a supervisor phase heartbeat (no-op without an armed
    supervisor)."""
    from trlx_tpu_torch import supervisor, telemetry

    span = telemetry.device_phase(name)
    heartbeat = supervisor.phase(name)
    if heartbeat is supervisor.NULL_CM:
        return span
    return _Stacked(span, heartbeat)
