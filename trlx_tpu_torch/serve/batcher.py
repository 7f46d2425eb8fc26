"""Request objects and admission errors (port of the subset of
trlx_tpu.serve.batcher the slot scheduler uses: ``:64-120, 314-385``).

The static batch-to-completion ``MicroBatcher``, tenants/quotas and the
replay journal are not ported in this slice.
"""

import itertools
import threading
from typing import List, Optional

from trlx_tpu_torch.supervisor import monotonic


class QueueFull(RuntimeError):
    """Admission control rejection: the serve queue is at ``max_queue``.
    Clients should back off and retry (HTTP 429)."""


#: global admission order: same-class requests admit FIFO by this stamp
_SEQ = itertools.count()


class Request:
    """One queued generation request and its completion slot."""

    __slots__ = ("tokens", "max_new_tokens", "seed", "shape",
                 "enqueued_at", "done", "result", "error", "latency_s",
                 "seq")

    def __init__(self, tokens: List[int], max_new_tokens: int, shape,
                 seed: Optional[int] = None):
        self.tokens = tokens
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.shape = shape  # (prompt_len, gen_len) class
        self.enqueued_at = monotonic()
        self.done = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.latency_s: float = 0.0
        self.seq = next(_SEQ)

    def wait(self, timeout: Optional[float] = None) -> "Request":
        """Block until decoded; re-raises the worker-side error if the
        step failed, raises TimeoutError if `timeout` expires first."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request not decoded within {timeout:.3g}s (queue "
                f"backlog or a stalled decode — check serve/queue_depth)"
            )
        if self.error is not None:
            raise self.error
        return self
