"""Divergence containment and bounded host-side fault tolerance (port
of trlx_tpu.utils.faults: ``StepGuard``, ``DivergenceError`` and
``retry_call``).

The trainers' steps carry a commit gate: with ``train.max_bad_steps >
0`` a step whose loss or gradient norm is not finite (or, for PPO, whose
KL exceeds ``train.max_step_kl``) leaves the parameters and the
optimizer state as they were, on the device, and reports ``bad_step``.
:class:`StepGuard` turns that stream of verdicts into policy:
``max_bad_steps`` bad steps in a row roll back to the latest checkpoint,
a good step resets the streak, and a second strike after a rollback
aborts with :class:`DivergenceError`. Events count as ``fault/*``
telemetry counters.

User ``reward_fn`` callbacks and tracker emissions sit outside the
device work and fail transiently: :func:`retry_call` gives them bounded
retries with decorrelated-jitter backoff, and with ``timeout=`` a seam
that HANGS times out too (trlx_tpu_torch.supervisor.seams), which the
learn loops turn into a clean checkpoint-and-exit.
"""

import random
import time
from typing import Any, Callable, Dict, Optional

from trlx_tpu_torch import telemetry

#: backoff jitter stream, intentionally UNSEEDED: after a shared-sink
#: outage every rank retries, and a deterministic schedule would
#: synchronise those retries into storms
_JITTER = random.Random()


class DivergenceError(RuntimeError):
    """Training diverged beyond what rollback can contain; the message
    carries the containment history."""


def retry_call(
    fn: Callable,
    *args: Any,
    retries: int = 2,
    backoff: float = 0.5,
    label: str = "",
    log: Callable[[str], None] = print,
    timeout: float = 0.0,
    seam: str = "",
    retry_after_s: Any = None,
    **kwargs: Any,
):
    """``fn(*args, **kwargs)`` with up to ``retries`` retries on an
    exception, and the LAST exception re-raised once the budget is spent
    (``retries=0`` is a plain call). Each retry counts
    ``fault/host_retries``, the give-up ``fault/host_giveups``.

    - backoff: the delay draws ``uniform(backoff, prev_delay * 3)``,
      capped at ``backoff * 2**retries``, from an unseeded per-process
      stream (decorrelated jitter); ``backoff=0`` never sleeps;
    - ``timeout > 0`` runs each attempt through a bounded worker
      (:func:`trlx_tpu_torch.supervisor.seams.bounded_call`): a HUNG
      attempt raises ``SeamTimeout`` and consumes one retry; exhaustion
      re-raises it, and SeamTimeout IS-A StallError, which the learn
      loops contain as a checkpoint-and-exit;
    - ``seam`` names a chaos point (trlx_tpu_torch.supervisor.chaos)
      fired INSIDE each attempt, so an injected hang is bounded by
      ``timeout`` and an injected exception consumes a retry, as the
      real faults would;
    - ``retry_after_s``: a float, or a callable of the attempt's
      exception returning a float or None; a value >= 0 is the next
      delay, and the jitter state is left as it was."""
    from trlx_tpu_torch.supervisor import bounded_call, chaos

    def attempt_once():
        if seam:
            chaos.maybe_inject(seam)
        return fn(*args, **kwargs)

    attempt = 0
    prev_delay = backoff
    while True:
        try:
            if timeout and timeout > 0:
                return bounded_call(
                    attempt_once, timeout=timeout,
                    label=label or seam or getattr(fn, "__name__", "call"),
                )
            return attempt_once()
        except Exception as e:
            attempt += 1
            if attempt > retries:
                telemetry.inc("fault/host_giveups")
                raise
            telemetry.inc("fault/host_retries")
            hint = None
            if retry_after_s is not None:
                hint = retry_after_s(e) if callable(retry_after_s) \
                    else retry_after_s
            if hint is not None and float(hint) >= 0:
                delay = float(hint)
            elif backoff > 0:
                delay = min(_JITTER.uniform(backoff, prev_delay * 3.0),
                            backoff * (2.0 ** retries))
                prev_delay = delay
            else:
                delay = 0.0
            log(
                f"[trlx_tpu_torch] {label or getattr(fn, '__name__', 'call')}"
                f" failed ({type(e).__name__}: {e}); retry "
                f"{attempt}/{retries} in {delay:.2g}s"
            )
            if delay > 0:
                time.sleep(delay)


class StepGuard:
    """Host-side divergence containment for a learn loop.

    - a bad step is counted and logged (the update was already skipped
      on the device);
    - ``max_bad_steps`` CONSECUTIVE bad steps call ``rollback_fn``
      (restore the latest checkpoint); a good step resets the streak;
    - with ``max_rollbacks`` used up — the second strike — or with no
      checkpoint to restore, :class:`DivergenceError`.

    ``max_bad_steps <= 0`` disables the guard (``enabled`` False), and
    the trainers then read no verdict from the device.
    """

    def __init__(self, max_bad_steps: int = 0,
                 rollback_fn: Optional[Callable[[], Optional[str]]] = None,
                 max_rollbacks: int = 1,
                 log: Callable[[Dict[str, Any]], None] = None):
        self.max_bad_steps = int(max_bad_steps)
        self.rollback_fn = rollback_fn
        self.max_rollbacks = int(max_rollbacks)
        self.log = log or (lambda stats: print(stats, flush=True))
        self.bad_streak = 0
        self.total_bad = 0
        self.rollbacks = 0
        self._history = []

    @property
    def enabled(self) -> bool:
        return self.max_bad_steps > 0

    def observe(self, bad: bool, step: int,
                detail: Optional[Dict] = None) -> str:
        """Record one verdict; returns "ok", "skipped" or "rollback", or
        raises :class:`DivergenceError`."""
        if not self.enabled or not bad:
            self.bad_streak = 0
            return "ok"
        self.bad_streak += 1
        self.total_bad += 1
        telemetry.inc("fault/skipped_steps")
        self._history.append((int(step), dict(detail or {})))
        self.log({"iter": step, "skipped_step": 1.0,
                  "bad_streak": self.bad_streak, **(detail or {})})
        if self.bad_streak < self.max_bad_steps:
            return "skipped"
        if self.rollbacks >= self.max_rollbacks:
            telemetry.inc("fault/divergence_aborts")
            raise DivergenceError(self._diagnostic(step, strike=True))
        restored = self.rollback_fn() if self.rollback_fn else None
        if restored is None:
            telemetry.inc("fault/divergence_aborts")
            raise DivergenceError(self._diagnostic(step, strike=False))
        self.rollbacks += 1
        telemetry.inc("fault/rollbacks")
        self.bad_streak = 0
        self.log({"iter": step, "rollback": 1.0,
                  "restored_from": str(restored)})
        return "rollback"

    def _diagnostic(self, step, strike: bool) -> str:
        recent = ", ".join(
            f"step {s}: " + " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                                     else f"{k}={v}" for k, v in d.items())
            for s, d in self._history[-5:]
        ) or "no per-step detail recorded"
        if strike:
            cause = (f"{self.bad_streak} consecutive bad steps AGAIN after "
                     f"{self.rollbacks} rollback(s) to the last checkpoint")
        else:
            cause = (f"{self.bad_streak} consecutive bad steps and no "
                     f"checkpoint to roll back to (save one before the run "
                     f"diverges: train.checkpoint_interval)")
        return (
            f"training diverged at iter {step}: {cause}. {self.total_bad} "
            f"bad steps total; recent: [{recent}]. Bad = non-finite loss or "
            f"grad norm, or KL above train.max_step_kl; the skipped updates "
            f"never touched params, so the model state equals the last good "
            f"step. Likely fixes: lower learning_rate_init, clip gradients "
            f"harder (grad_clip), lower max_step_kl, or inspect the reward "
            f"scale.")
