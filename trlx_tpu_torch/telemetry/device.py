"""Device monitor: device-memory gauges from the CUDA caching allocator
(trlx_tpu.telemetry.device re-targeted to the card).

Sampled at metric-emission boundaries, not per step. The gauges keep
the reference's names:

- ``device/hbm_in_use_gb``: ``torch.cuda.memory_stats()``'s
  ``allocated_bytes.all.current``;
- ``device/hbm_peak_gb``: its ``allocated_bytes.all.peak``, which is
  ``torch.cuda.max_memory_allocated()``;
- ``device/hbm_limit_gb``: the card's total memory from
  ``torch.cuda.mem_get_info()`` (read once: it does not change);
- ``device/hbm_utilization``: in use over the limit.

These are the caching allocator's bytes. They leave out whatever the
allocator does not back: the CUDA context, and the cuBLAS workspace and
a CUDA graph's private pool only where those are not allocator-backed.
All of it is host reads of the allocator's counters and one driver
query: no stream is synchronised.

Without a card (no CUDA in the process) the first sample latches the
monitor silent for the rest of the process, as the reference latches
when its runtime exposes no memory stats; before anything has
initialised CUDA a sample sets nothing (it must not initialise it).

The module also holds the one way the port times device work:
:func:`timing_event`, a CUDA event recorded on the current stream, which
the tracer's device phases pair up while a profiler records
(:func:`profiler_recording`) and the ILQL trainer's ``step_events``
record around the parts of an update.
"""

import sys
from typing import Optional

from trlx_tpu_torch.telemetry.registry import MetricsRegistry

_available = True  # latches False on the first failed sample
_limit_bytes: Optional[int] = None


def sample_device_stats(registry: MetricsRegistry) -> None:
    global _available, _limit_bytes
    if not _available:
        return
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        if not torch.cuda.is_initialized():
            return  # nothing on the card yet; sampling would initialise it
        stats = torch.cuda.memory_stats()
        if _limit_bytes is None:
            _limit_bytes = int(torch.cuda.mem_get_info()[1])
    except Exception:
        _available = False
        return
    in_use = stats.get("allocated_bytes.all.current", 0)
    registry.set_gauge("device/hbm_in_use_gb", in_use / 2**30)
    registry.set_gauge("device/hbm_peak_gb",
                       stats.get("allocated_bytes.all.peak", 0) / 2**30)
    registry.set_gauge("device/hbm_limit_gb", _limit_bytes / 2**30)
    if _limit_bytes:
        registry.set_gauge("device/hbm_utilization", in_use / _limit_bytes)


# --------------------------------------------------------------------- #
# device time of a phase: one timing path (the tracer's device phases
# and the ILQL trainer's ``step_events`` both record through it)
# --------------------------------------------------------------------- #


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` records on this thread, whoever
    started it (``maybe_trace``, a benchmark, a notebook)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)) or torch._C._autograd._profiler_enabled()


def timing_event():
    """A timing CUDA event recorded now on the current stream, or None
    where there is nothing to time: no card, CUDA not initialised yet
    (this must not initialise it), or the stream being captured into a
    graph (the record would become part of the graph)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or \
            not torch.cuda.is_initialized() or \
            torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event
