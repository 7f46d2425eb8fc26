"""Inference serving on the card (port of trlx_tpu.serve).

- :class:`InferenceEngine` (serve.engine) — a policy's decode views on
  one device (or a process's slices on the serve mesh) + the bucket
  lattice and paged-pool geometry; weights
  hot-swap in place;
- :class:`SlotScheduler` (serve.slots) — continuous batching over a
  paged KV pool with radix-tree prefix caching (serve.paged), or a
  contiguous one, with speculative decoding (serve.speculate), tenant
  quotas and brownout, poisoned-step replay, drain and hot-swap;
- :class:`MicroBatcher` (serve.batcher) — the static batch-to-completion
  driver (``serve.scheduler: static``);
- ``RequestTrace``, ``FlightRecorder``, ``SloEngine`` (serve.trace) — request tracing, the engine-step black box and the
  windowed SLO gauges;
- :class:`InferenceServer` (serve.server) — stdlib JSON API
  (``POST /generate``, ``/admin/drain``, ``/admin/reload``; ``GET
  /healthz``, ``/readyz``, ``/metrics``, ``/debug/state``,
  ``/debug/slo``) and the serve watchdog;
- the tp serve mesh (``serve.mesh``): the decode placements and their
  operators (serve.layouts) and the follower processes that mirror
  process 0's device calls (serve.follower).
"""

from trlx_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    QueueFull,
    Request,
)
from trlx_tpu_torch.serve.engine import InferenceEngine, ServeConfig  # noqa: F401
from trlx_tpu_torch.serve.server import InferenceServer  # noqa: F401
from trlx_tpu_torch.serve.slots import SlotScheduler  # noqa: F401

#: the same public names as trlx_tpu.serve; the typed errors and tenant
#: tables live in serve.batcher, the tracing types in serve.trace
__all__ = [
    "InferenceEngine",
    "InferenceServer",
    "MicroBatcher",
    "QueueFull",
    "Request",
    "ServeConfig",
    "SlotScheduler",
]
