"""Inference serving on the card (port of trlx_tpu.serve, this slice).

- :class:`InferenceEngine` (serve.engine) — a policy's decode views on
  one device + the bucket lattice and paged-pool geometry;
- :class:`SlotScheduler` (serve.slots) — continuous batching over a
  paged KV pool with radix-tree prefix caching (serve.paged), or a
  contiguous one, with speculative decoding (serve.speculate);
- :class:`MicroBatcher` (serve.batcher) — the static batch-to-completion
  driver (``serve.scheduler: static``);
- :class:`InferenceServer` (serve.server) — stdlib JSON API
  (``POST /generate``, ``GET /healthz``, ``GET /metrics``).
"""

from trlx_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    QueueFull,
    Request,
)
from trlx_tpu_torch.serve.engine import InferenceEngine, ServeConfig  # noqa: F401
from trlx_tpu_torch.serve.server import InferenceServer  # noqa: F401
from trlx_tpu_torch.serve.slots import SlotScheduler  # noqa: F401

__all__ = [
    "InferenceEngine",
    "InferenceServer",
    "MicroBatcher",
    "QueueFull",
    "Request",
    "ServeConfig",
    "SlotScheduler",
]
