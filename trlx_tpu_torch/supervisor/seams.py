"""Bounded host-seam calls: timeouts that fire on a HUNG call (copy of
trlx_tpu.supervisor.seams).

``retry_call`` (trlx_tpu_torch.utils.faults) contains a host seam that
*fails*; this module contains one that *hangs*: a reward_fn blocked on a
dead scoring service, a tracker emission stuck in a TCP retry loop, a
checkpoint save wedged on a dead mount. A hung seam never raises, so a
retry budget never starts counting.

:func:`bounded_call` runs the callable in a fresh daemon worker thread
and waits ``timeout`` seconds. On expiry it raises :class:`SeamTimeout`
in the caller and ABANDONS the worker: Python cannot kill a thread, so
the stuck call keeps its thread until it returns or the process exits
(one abandoned thread per timed-out attempt, bounded by the retry
budget). A fresh thread per call: a pooled worker poisoned by a hung
call would starve every later seam.

On the card an abandoned worker may still hold CUDA work: a user
``reward_fn`` that scores on the card keeps launching from its own
thread. PyTorch's current stream is per thread (a new thread starts on
the default stream), and the port's CUDA-graph captures run in
``thread_local`` mode (trlx_tpu_torch.utils.aotjit), so another
thread's launches neither join nor break a capture.

Error taxonomy: :class:`SeamTimeout` IS-A :class:`StallError` IS-A
``RuntimeError``; the learn loops contain every :class:`StallError` as a
clean checkpoint-and-exit.
"""

import threading
from typing import Any, Callable


class StallError(RuntimeError):
    """A run phase stalled beyond containment: a host seam hung past its
    timeout and retry budget, or the heartbeat watchdog escalated a
    stalled phase. The learn loops convert this into a clean
    checkpoint-and-exit — the checkpoint is resumable via
    ``train.resume_from: auto``."""


class SeamTimeout(StallError, TimeoutError):
    """A bounded host-seam call exceeded its timeout while HUNG (as
    opposed to raising). Counted in ``fault/seam_timeouts``; inside
    ``retry_call`` it consumes one retry attempt like any failure."""


def bounded_call(fn: Callable[[], Any], timeout: float, label: str = "") -> Any:
    """``fn()`` in a fresh daemon worker, bounded by ``timeout`` seconds.

    Returns the callable's result or re-raises its exception. On timeout
    raises :class:`SeamTimeout` (and increments ``fault/seam_timeouts``);
    the worker thread is abandoned and its eventual result discarded.
    ``timeout <= 0`` is a plain unbounded call.
    """
    if timeout is None or timeout <= 0:
        return fn()
    outcome = {}
    done = threading.Event()

    def run():
        try:
            outcome["value"] = fn()
        except BaseException as e:  # re-raised in the caller below
            outcome["error"] = e
        finally:
            done.set()

    worker = threading.Thread(
        target=run, daemon=True, name=f"trlx-seam-{label or 'call'}"
    )
    worker.start()
    if not done.wait(timeout):
        from trlx_tpu_torch import telemetry

        telemetry.inc("fault/seam_timeouts")
        raise SeamTimeout(
            f"host seam '{label or getattr(fn, '__name__', 'call')}' hung "
            f"past its {timeout:.3g}s timeout (train.host_call_timeout / "
            f"train.stall_timeout); the worker thread is abandoned. A "
            f"hung — not failing — seam usually means a dead downstream "
            f"service (scoring endpoint, tracker backend, checkpoint "
            f"filesystem)."
        )
    if "error" in outcome:
        raise outcome["error"]
    return outcome.get("value")
