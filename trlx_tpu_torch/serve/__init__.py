"""Inference serving on the card (port of trlx_tpu.serve, this slice).

- :class:`InferenceEngine` (serve.engine) — a policy's decode views on
  one device + the bucket lattice and paged-pool geometry;
- :class:`SlotScheduler` (serve.slots) — continuous batching over a
  paged KV pool with radix-tree prefix caching (serve.paged);
- :class:`InferenceServer` (serve.server) — stdlib JSON API
  (``POST /generate``, ``GET /healthz``, ``GET /metrics``).
"""

from trlx_tpu_torch.serve.batcher import QueueFull, Request  # noqa: F401
from trlx_tpu_torch.serve.engine import InferenceEngine, ServeConfig  # noqa: F401
from trlx_tpu_torch.serve.server import InferenceServer  # noqa: F401
from trlx_tpu_torch.serve.slots import SlotScheduler  # noqa: F401

__all__ = [
    "InferenceEngine",
    "InferenceServer",
    "QueueFull",
    "Request",
    "ServeConfig",
    "SlotScheduler",
]
