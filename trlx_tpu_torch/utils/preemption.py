"""Preemption-safe training (port of trlx_tpu.utils.preemption): trap
SIGTERM during ``learn()`` and checkpoint before returning.

Batch schedulers (node drains, spot VMs, SLURM) send SIGTERM ahead of
eviction. The learn loops poll the guard's flag at step boundaries,
save the normal checkpoint and return; the run then resumes through
``train.resume_from``. The guard starts no thread.
"""

import signal
import threading


def _world_size() -> int:
    """Processes in the default ``torch.distributed`` group (1 when none
    is initialised)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _any_rank(flag: bool) -> bool:
    """True when ``flag`` is set on any rank (an all-reduce of the max; on
    this process's card under NCCL, which reduces no CPU tensor)."""
    import torch
    import torch.distributed as dist

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


class PreemptionGuard:
    """Context manager that records SIGTERM instead of dying.

    Only the main thread may install signal handlers; constructed
    anywhere else, or with ``enabled=False``
    (``train.save_on_preemption: false``), the guard is inert and
    ``requested`` stays False. The previous handler is restored on exit.
    """

    def __init__(self, enabled: bool = True, poll_interval: int = 1):
        self.requested = False
        self._enabled = enabled
        self._prev = None
        self._installed = False
        # ranks agree on the flag with a collective only every
        # poll_interval-th call; the call count is the same on every rank
        self._poll_interval = max(1, int(poll_interval))
        self._polls = 0

    def _on_signal(self, signum, frame):
        self.requested = True
        from trlx_tpu_torch import telemetry

        telemetry.inc("fault/preempt_sigterm")

    def poll(self, extra: bool = False) -> bool:
        """The stop flag agreed across processes: any rank's SIGTERM (or
        ``extra``) stops every rank, at the same boundary. Between the
        collective boundaries (every ``poll_interval``-th call) it
        returns False, since a rank acting alone would leave the others
        waiting in a collective. With one process: the local flags,
        every call."""
        local = self.requested or bool(extra)
        if _world_size() == 1:
            return local
        self._polls += 1
        if (self._polls - 1) % self._poll_interval:
            return False
        return _any_rank(local)

    def __enter__(self) -> "PreemptionGuard":
        if self._enabled and \
                threading.current_thread() is threading.main_thread():
            self._prev = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        return self

    def __exit__(self, *exc) -> bool:
        """Restore the previous SIGTERM disposition. A handler installed
        at the C level reads back as None and cannot be reinstalled from
        Python: ``SIG_DFL`` takes its place rather than this guard's
        recording handler, which nothing polls after ``learn()``."""
        if self._installed:
            signal.signal(signal.SIGTERM,
                          self._prev if self._prev is not None
                          else signal.SIG_DFL)
            self._installed = False
        return False
