"""Run supervisor: heartbeat watchdog, walltime deadline, stall
escalation (port of trlx_tpu.supervisor).

A run that silently HANGS (a reward_fn blocked on a dead scoring
service, a wedged kernel, a checkpoint save on a dead mount) burns its
reservation with no signal. This package bounds every way a run can
stop making progress:

- **Heartbeat watchdog** (:class:`RunSupervisor`, ``train.stall_timeout``):
  the learn loops mark their phases (``rollout``, ``reward_fn``,
  ``ppo_update`` / ``ilql_update``, ``eval``, ``checkpoint_save``)
  through :func:`phase`; a daemon thread checks the innermost open phase
  against its budget. The FIRST occurrence of each phase gets
  ``train.stall_first_timeout`` (default 5x): on the card it holds the
  ``nvcc`` build of the kernels it reaches (trlx_tpu_torch.ops._build),
  the CUDA-graph capture of the decode step (utils/aotjit.py) and the
  cuBLAS and allocator warm-up. A breach is a STALL: every thread's
  stack goes to stderr, ``telemetry.json`` / ``trace.jsonl`` flush,
  ``fault/stalls`` counts. ``train.stall_grace`` seconds later a phase
  still stalled ESCALATES: ``train.stall_action`` ``"checkpoint_exit"``
  runs a bounded rescue checkpoint from the watchdog thread and exits 75
  (EX_TEMPFAIL: a scheduler restarts, ``resume_from: auto`` continues),
  ``"abort"`` exits 70 at once. A loop that is stalled but alive (a hung
  seam whose timeout fires) instead exits through StallError
  containment in the learn loops.
- **Host-seam timeouts** (trlx_tpu_torch.supervisor.seams): ``retry_call``
  takes ``timeout=`` and runs each attempt through a bounded worker;
  reward_fn, tracker emissions and checkpoint saves go through it
  (``train.host_call_timeout`` / ``train.checkpoint_timeout``).
- **Walltime deadline** (``train.max_walltime``): the loops checkpoint
  and return cleanly before the reservation ends, agreeing across ranks
  through the PreemptionGuard poll.
- **Chaos injection** (trlx_tpu_torch.supervisor.chaos,
  ``$TRLX_TPU_CHAOS`` / ``train.chaos``): hangs, exceptions, slow calls
  and SIGTERM at the named seams, so each path above runs on demand.

On the card the phases time the HOST, and CUDA runs asynchronously: a
phase that closed right after its launches would hand its device time,
and a hung kernel, to whichever later phase waits. So every budgeted
phase closes after its results reach the host: ``ppo_update`` /
``ilql_update`` after a device sync, ``rollout`` after the harvest's
copies to the host, ``eval`` after the sampled tokens come back,
``checkpoint_save`` after the tensors are written. Pushing and popping a
phase, a heartbeat and the watchdog's poll are host work only: no
stream is synchronised.
"""

import contextlib
import os
import sys
import threading
import traceback
from time import monotonic as _monotonic
from typing import Callable, Optional

from trlx_tpu_torch.supervisor.seams import (  # noqa: F401  (re-exports)
    SeamTimeout,
    StallError,
    bounded_call,
)

#: the containment clock: the watchdog's budgets and the serve path's
#: timestamps (serve/slots.py, serve/batcher.py) take monotonic time from
#: here; measurements go through trlx_tpu_torch.telemetry
monotonic = _monotonic

#: reusable no-op context manager (nullcontext is reentrant)
NULL_CM = contextlib.nullcontext()

_EXIT_CHECKPOINTED = 75  # EX_TEMPFAIL: rescue attempted, restart + resume
_EXIT_ABORTED = 70  # EX_SOFTWARE: hard abort per train.stall_action


def seam_timeout(train) -> float:
    """Effective bounded-worker timeout for host seams:
    ``train.host_call_timeout``, falling back to ``train.stall_timeout``;
    0 = unbounded (reference-parity behavior)."""
    return float(
        getattr(train, "host_call_timeout", 0.0)
        or getattr(train, "stall_timeout", 0.0)
        or 0.0
    )


class _PhaseCM:
    """Push/pop one named phase on the supervisor's heartbeat stack."""

    __slots__ = ("sup", "name")

    def __init__(self, sup: "RunSupervisor", name: str):
        self.sup = sup
        self.name = name

    def __enter__(self):
        self.sup._push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.sup._pop()
        return False


class RunSupervisor:
    """One learn loop's supervisor: heartbeat watchdog + walltime clock.

    Used as a context manager around the loop (the trainers build it via
    ``BaseRLTrainer._make_supervisor``); entering registers it as the
    process's active supervisor so :func:`phase` / :func:`beat` reach it
    from the orchestrator and utility layers without plumbing. Inert —
    but still a valid context manager — when every knob is 0.

    Only the OWNER thread (the one that entered the context) feeds the
    phase stack; phases opened from other threads (bounded seam workers,
    rescue saves) are no-ops, so the watchdog always describes the learn
    loop itself.
    """

    def __init__(
        self,
        stall_timeout: float = 0.0,
        stall_first_timeout: float = 0.0,
        stall_grace: float = 60.0,
        stall_action: str = "checkpoint_exit",
        max_walltime: float = 0.0,
        rescue_fn: Optional[Callable[[], None]] = None,
        exit_fn: Callable[[int], None] = os._exit,
    ):
        if stall_action not in ("checkpoint_exit", "abort"):
            raise ValueError(
                f"train.stall_action '{stall_action}' is not one of: "
                f"checkpoint_exit, abort"
            )
        self.stall_timeout = float(stall_timeout)
        self.stall_first_timeout = (
            float(stall_first_timeout) or 5.0 * self.stall_timeout
        )
        self.stall_grace = float(stall_grace)
        self.stall_action = stall_action
        self.max_walltime = float(max_walltime)
        self.rescue_fn = rescue_fn
        self.exit_fn = exit_fn

        #: extra state dumpers run alongside the stack dump on a stall
        #: (add_dump_fn) — e.g. the slot scheduler's flight recorder, so
        #: a stall shows the engine's last N steps, not just frames
        self.dump_fns = []
        self.stalls = 0
        self.escalated = False
        self.stalled_phase: Optional[str] = None
        self._deadline_noticed = False
        self._phases = []  # stack of [name, start, token, first, entered]
        #: wall seconds of each phase's first occurrence, the calls the
        #: first-call budget covered (on the card: builds and captures)
        self.first_call_s = {}
        self._seen = set()
        self._token = 0
        self._lock = threading.Lock()
        self._owner: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None

    # -- lifecycle ------------------------------------------------------ #

    def __enter__(self) -> "RunSupervisor":
        global _active
        self._owner = threading.get_ident()
        self._started_at = _monotonic()
        _active = self
        if self.stall_timeout > 0:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="trlx-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        global _active
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if _active is self:
            _active = None
        return False

    # -- heartbeats ----------------------------------------------------- #

    def phase(self, name: str):
        """Context manager marking one named phase on the owner thread's
        heartbeat stack (no-op from any other thread, and when the
        watchdog is disabled)."""
        if (
            self.stall_timeout <= 0
            or threading.get_ident() != self._owner
        ):
            return NULL_CM
        return _PhaseCM(self, name)

    def beat(self) -> None:
        """Reset the innermost phase's stall timer — progress heartbeat
        for long phases with internal structure (e.g. the rollout harvest
        beats once per scored chunk)."""
        if threading.get_ident() != self._owner:
            return
        with self._lock:
            if self._phases:
                self._phases[-1][1] = _monotonic()

    def _push(self, name: str) -> None:
        with self._lock:
            self._token += 1
            first = name not in self._seen
            self._seen.add(name)
            now = _monotonic()
            self._phases.append([name, now, self._token, first, now])

    def _pop(self) -> None:
        with self._lock:
            if self._phases:
                name, _, _, first, entered = self._phases.pop()
                if first:
                    self.first_call_s[name] = _monotonic() - entered

    # -- stop conditions ------------------------------------------------ #

    def deadline_reached(self) -> bool:
        """Walltime deadline passed (False when disabled or not yet
        entered)."""
        if self.max_walltime <= 0 or self._started_at is None:
            return False
        return (_monotonic() - self._started_at) >= self.max_walltime

    def stop_requested(self) -> bool:
        """True when the loop should save-and-exit at the next boundary:
        walltime deadline passed, or a stall escalated while the loop was
        (intermittently) alive."""
        if self.escalated:
            return True
        if not self.deadline_reached():
            return False
        if not self._deadline_noticed:
            self._deadline_noticed = True
            from trlx_tpu_torch import telemetry

            telemetry.inc("fault/walltime_exits")
            print(
                f"[trlx_tpu_torch] walltime deadline: loop has run "
                f">= train.max_walltime={self.max_walltime:.6g}s; "
                f"checkpointing and exiting cleanly",
                file=sys.stderr, flush=True,
            )
        return True

    def stop_reason(self) -> str:
        """Metrics key for the stop: ``stalled`` or
        ``walltime_exceeded``."""
        return "stalled" if self.escalated else "walltime_exceeded"

    # -- watchdog ------------------------------------------------------- #

    def _snapshot(self):
        with self._lock:
            if not self._phases:
                return None
            return tuple(self._phases[-1])

    def _watch(self) -> None:
        poll = max(0.02, self.stall_timeout / 8.0)
        dumped_token = None
        while not self._stop.wait(poll):
            top = self._snapshot()
            if top is None:
                continue
            name, start, token, first, _ = top
            budget = (
                self.stall_first_timeout if first else self.stall_timeout
            )
            elapsed = _monotonic() - start
            if elapsed <= budget:
                continue
            if token != dumped_token:
                dumped_token = token
                self._on_stall(name, elapsed, budget, first)
            elif not self.escalated and elapsed > budget + self.stall_grace:
                self._escalate(name, elapsed)

    def _on_stall(self, name, elapsed, budget, first) -> None:
        from trlx_tpu_torch import telemetry

        self.stalls += 1
        self.stalled_phase = name
        telemetry.inc("fault/stalls")
        knob = (
            "train.stall_first_timeout (a first call holds builds and "
            "captures)"
            if first else "train.stall_timeout"
        )
        header = (
            f"[trlx_tpu_torch] STALL: phase '{name}' has run {elapsed:.1f}s, "
            f"over its {budget:.1f}s budget ({knob}). "
            f"Dumping all thread stacks; escalation "
            f"({self.stall_action}) in {self.stall_grace:.1f}s unless the "
            f"phase completes."
        )
        print(header, file=sys.stderr, flush=True)
        self._dump_stacks()
        self._run_dump_fns()
        self._flush_telemetry()

    def add_dump_fn(self, fn: Callable[[], None]) -> None:
        """Register an extra state dumper to run on every stall (after
        the stack dump) — subsystems attach their black boxes here (the
        serve flight recorder); a dumper that raises is reported and
        skipped, never letting diagnostics kill containment."""
        self.dump_fns.append(fn)

    def _run_dump_fns(self) -> None:
        for fn in self.dump_fns:
            try:
                fn()
            except Exception as e:
                print(
                    f"[trlx_tpu_torch] stall state dump {fn!r} failed ({e!r}); "
                    f"continuing",
                    file=sys.stderr, flush=True,
                )

    def _dump_stacks(self) -> None:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            who = names.get(ident, "unknown")
            print(
                f"[trlx_tpu_torch] --- thread {who} (ident {ident}) ---\n"
                + "".join(traceback.format_stack(frame)),
                file=sys.stderr, flush=True,
            )

    def _flush_telemetry(self) -> None:
        """Best-effort mid-run telemetry.json/trace.jsonl flush so the
        stall is on disk even if the process never exits cleanly."""
        from trlx_tpu_torch import telemetry

        tel = telemetry.current()
        if tel is None:
            return
        try:
            tel.write()
        except Exception as e:
            print(
                f"[trlx_tpu_torch] stall telemetry flush failed ({e!r}); "
                f"continuing",
                file=sys.stderr, flush=True,
            )

    def _escalate(self, name, elapsed) -> None:
        from trlx_tpu_torch import telemetry

        self.escalated = True
        telemetry.inc("fault/stall_escalations")
        print(
            f"[trlx_tpu_torch] STALL ESCALATION: phase '{name}' still stalled "
            f"after {elapsed:.1f}s (> budget + train.stall_grace); "
            f"action: {self.stall_action}",
            file=sys.stderr, flush=True,
        )
        code = _EXIT_ABORTED
        if self.stall_action == "checkpoint_exit":
            code = _EXIT_CHECKPOINTED
            if self.rescue_fn is not None:
                try:
                    self.rescue_fn()
                    print(
                        "[trlx_tpu_torch] rescue checkpoint committed; exiting "
                        f"{code} (resume via train.resume_from: auto)",
                        file=sys.stderr, flush=True,
                    )
                except Exception as e:
                    print(
                        f"[trlx_tpu_torch] rescue checkpoint failed ({e!r}); "
                        f"the last interval checkpoint remains the resume "
                        f"point",
                        file=sys.stderr, flush=True,
                    )
        self._flush_telemetry()
        self.exit_fn(code)

    # -- construction --------------------------------------------------- #

    @classmethod
    def from_config(cls, train, rescue_fn=None, exit_fn=os._exit):
        """Build from the TrainConfig knobs (all default-off — an unset
        config yields an inert supervisor)."""
        return cls(
            stall_timeout=getattr(train, "stall_timeout", 0.0),
            stall_first_timeout=getattr(train, "stall_first_timeout", 0.0),
            stall_grace=getattr(train, "stall_grace", 60.0),
            stall_action=getattr(
                train, "stall_action", "checkpoint_exit"
            ),
            max_walltime=getattr(train, "max_walltime", 0.0),
            rescue_fn=rescue_fn,
            exit_fn=exit_fn,
        )


# ------------------------------------------------------------------ #
# module-level API: the one active supervisor + no-op-when-idle hooks
# ------------------------------------------------------------------ #

_active: Optional[RunSupervisor] = None


def current() -> Optional[RunSupervisor]:
    return _active


def phase(name: str):
    """The active supervisor's phase heartbeat for ``name``; a reusable
    no-op context manager when no supervisor is active (library imports
    and supervisor-off runs pay one None check)."""
    sup = _active
    if sup is None:
        return NULL_CM
    return sup.phase(name)


def beat() -> None:
    """Progress heartbeat into the active supervisor's innermost phase
    (no-op without one)."""
    sup = _active
    if sup is not None:
        sup.beat()
