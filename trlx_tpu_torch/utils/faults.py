"""Divergence containment (port of trlx_tpu.utils.faults: ``StepGuard``
and ``DivergenceError``).

The trainers' steps carry a commit gate: with ``train.max_bad_steps >
0`` a step whose loss or gradient norm is not finite (or, for PPO, whose
KL exceeds ``train.max_step_kl``) leaves the parameters and the
optimizer state as they were, on the device, and reports ``bad_step``.
:class:`StepGuard` turns that stream of verdicts into policy:
``max_bad_steps`` bad steps in a row roll back to the latest checkpoint,
a good step resets the streak, and a second strike after a rollback
aborts with :class:`DivergenceError`. Events count as ``fault/*``
telemetry counters. Retries around host seams (``retry_call``) wait for
the run floor.
"""

from typing import Any, Callable, Dict, Optional

from trlx_tpu_torch import telemetry


class DivergenceError(RuntimeError):
    """Training diverged beyond what rollback can contain; the message
    carries the containment history."""


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
