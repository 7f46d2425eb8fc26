"""Deterministic chaos injection at named run seams (copy of
trlx_tpu.supervisor.chaos).

Every containment path (seam timeouts, the watchdog, StepGuard
rollback, preemption checkpoints) exists for a failure a test cannot
wait for. This module injects those failures ON SCHEDULE, from a plain
string, so each path runs on the CPU in the tests and on the card in
``chip_smoke.py``'s drills.

A schedule is a ``;``-separated list of rules::

    <seam>:<action>[=<param>][@<occurrences>]

- ``seam``: a named injection point from :data:`KNOWN_SEAMS`. The port's
  trainers fire ``reward_fn`` and ``tracker`` before each *attempt*
  inside ``retry_call`` (an injected hang lands inside the bounded
  worker, an injected exception consumes a retry), and the phase seams
  ``rollout``, ``ppo_update``, ``ilql_update``, ``eval`` and
  ``checkpoint_save`` once at phase entry. The serve schedulers fire
  ``serve_decode`` (each static batch or slot step), ``serve_admit``
  (each slot admission) and ``serve_speculate`` (each proposal
  gathering), with the other serving seams where trlx_tpu fires them.
  The fleet router (trlx_tpu_torch.router) fires ``router_route`` (once
  per request, before a replica is picked), ``router_probe`` (each
  prober sweep), ``router_rollout`` (each replica step of a rollout) and
  ``router_hedge`` (each hedge launch); ``verify_checkpoint`` fires
  ``checkpoint_verify`` first thing, an injected exc standing for a
  corrupt checkpoint.
- ``action``: ``hang`` (block ``param`` seconds, default 3600: a bounded
  seam times out, the watchdog sees everything else), ``exc`` (raise
  :class:`ChaosError`), ``slow`` (sleep ``param`` seconds, default 1,
  then proceed), ``sigterm`` (deliver SIGTERM to this process, which
  drives the PreemptionGuard path, then proceed).
- ``occurrences``: which 1-based calls of that seam fire: ``3``,
  ``1,2``, ``2-4``, mixes thereof, or ``*`` (every call, the default).

Examples::

    reward_fn:hang=30@3          # third reward_fn attempt hangs 30s
    reward_fn:exc@1,2            # first two attempts raise (retry drill)
    ppo_update:sigterm@2         # SIGTERM mid-epoch (preemption drill)

The schedule comes from ``$TRLX_TPU_CHAOS`` or ``train.chaos`` (the
environment wins), is parsed once, and counts calls per seam: the same
schedule against the same run injects at the same points. Injection
sites cost one module-global ``is None`` check when no schedule is
active.

Injected hangs wait on an event rather than a raw sleep: :func:`reset`
releases every in-flight hang by raising :class:`ChaosHang` in its
(already abandoned) worker, so a process does not accumulate sleeping
threads.
"""

import os
import re
import threading
import time
from typing import List, Optional, Tuple

ENV_VAR = "TRLX_TPU_CHAOS"

#: the closed seam namespace, the reference's: every injection point
#: (``maybe_inject(<seam>)``, ``retry_call(seam=...)``) names one of
#: these, and the port fires every one.
KNOWN_SEAMS = (
    # retry_call seams (fired per attempt, inside the bounded worker)
    "reward_fn",
    "tracker",
    # training phase seams (fired once at phase entry)
    "rollout",
    "ppo_update",
    "ilql_update",
    "eval",
    "checkpoint_save",
    # serving seams (trlx_tpu_torch.serve fires every one)
    "serve_admit",
    "serve_prefix_match",
    "serve_decode",
    "serve_request",
    "serve_quota",
    "serve_replay",
    "serve_reload",
    "serve_speculate",
    # fleet-router seams (trlx_tpu_torch.router)
    "router_route",
    "router_probe",
    "router_rollout",
    "router_hedge",
    # checkpoint-integrity seam (trlx_tpu_torch.utils.checkpoint)
    "checkpoint_verify",
)

_ACTIONS = ("hang", "exc", "slow", "sigterm")

_RULE_RE = re.compile(
    r"^(?P<seam>[A-Za-z0-9_./-]+):(?P<action>[a-z_]+)"
    r"(?:=(?P<param>[0-9.]+))?(?:@(?P<occ>[0-9,\-*]+))?$"
)


class ChaosError(RuntimeError):
    """The injected failure (action ``exc``)."""


class ChaosHang(RuntimeError):
    """An injected hang released early by :func:`reset` — only ever seen
    by abandoned bounded-call workers."""


class _Rule:
    __slots__ = ("seam", "action", "param", "spans")

    def __init__(self, seam: str, action: str, param: Optional[float],
                 spans: Optional[List[Tuple[int, int]]]):
        self.seam = seam
        self.action = action
        self.param = param
        self.spans = spans  # None = every occurrence

    def matches(self, n: int) -> bool:
        if self.spans is None:
            return True
        return any(lo <= n <= hi for lo, hi in self.spans)


def _parse_occurrences(occ: str) -> Optional[List[Tuple[int, int]]]:
    if occ == "*":
        return None
    spans = []
    for part in occ.split(","):
        if "-" in part:
            lo, hi = part.split("-", 1)
            spans.append((int(lo), int(hi)))
        else:
            spans.append((int(part), int(part)))
    return spans


def parse_schedule(spec: str) -> List[_Rule]:
    """Parse a schedule string; raises ``ValueError`` with the offending
    rule on any syntax error (a typo'd drill must fail loudly, not
    silently inject nothing)."""
    rules = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        m = _RULE_RE.match(raw)
        if m is None:
            raise ValueError(
                f"chaos rule '{raw}' does not parse; expected "
                f"'<seam>:<action>[=<param>][@<occurrences>]' "
                f"(e.g. 'reward_fn:hang=30@3')"
            )
        action = m.group("action")
        if action not in _ACTIONS:
            raise ValueError(
                f"chaos rule '{raw}': unknown action '{action}' "
                f"(known: {', '.join(_ACTIONS)})"
            )
        param = m.group("param")
        rules.append(_Rule(
            m.group("seam"), action,
            float(param) if param is not None else None,
            _parse_occurrences(m.group("occ") or "*"),
        ))
    return rules


class ChaosSchedule:
    """Parsed rules + deterministic per-seam call counters."""

    def __init__(self, rules: List[_Rule]):
        self.rules = rules
        self.counts = {}
        self.injected = 0

    def fire(self, seam: str) -> None:
        n = self.counts.get(seam, 0) + 1
        self.counts[seam] = n
        for rule in self.rules:
            if rule.seam == seam and rule.matches(n):
                self.injected += 1
                _execute(rule, seam, n)
                return  # first matching rule wins


# ------------------------------------------------------------------ #
# module state: one active schedule, one hang-release event
# ------------------------------------------------------------------ #

_schedule: Optional[ChaosSchedule] = None
_env_checked = False
_release = threading.Event()


def configure(spec: str) -> Optional[ChaosSchedule]:
    """Install (and return) the schedule parsed from ``spec`` — counters
    start fresh. Empty spec clears the schedule."""
    global _schedule, _env_checked
    _env_checked = True
    _schedule = ChaosSchedule(parse_schedule(spec)) if spec else None
    return _schedule


def configure_from(train) -> Optional[ChaosSchedule]:
    """The trainers' entry point: ``$TRLX_TPU_CHAOS`` overrides
    ``train.chaos``; when neither is set the current schedule (e.g. one a
    test installed via :func:`configure`) is left untouched."""
    spec = os.environ.get(ENV_VAR) or getattr(train, "chaos", "") or ""
    if spec:
        return configure(spec)
    return _schedule


def reset() -> None:
    """Clear the schedule and release every in-flight injected hang
    (they raise :class:`ChaosHang` in their abandoned workers)."""
    global _schedule, _env_checked, _release
    _schedule = None
    _env_checked = False
    old, _release = _release, threading.Event()
    old.set()


def active() -> Optional[ChaosSchedule]:
    """The current schedule, lazily initialized from ``$TRLX_TPU_CHAOS``
    the first time anything asks."""
    global _env_checked
    if _schedule is None and not _env_checked:
        configure(os.environ.get(ENV_VAR, ""))
    return _schedule


def maybe_inject(seam: str) -> None:
    """Fire the schedule at ``seam`` — the one call injection sites make.
    Free (a None check) when no schedule is active."""
    sched = active()
    if sched is not None:
        sched.fire(seam)


def _execute(rule: _Rule, seam: str, n: int) -> None:
    from trlx_tpu_torch import telemetry

    telemetry.inc("chaos/injections")
    print(
        f"[trlx_tpu_torch] chaos: injecting '{rule.action}' at seam "
        f"'{seam}' (call {n})",
        flush=True,
    )
    if rule.action == "exc":
        raise ChaosError(
            f"chaos: injected failure at seam '{seam}' (call {n})"
        )
    if rule.action == "slow":
        time.sleep(rule.param if rule.param is not None else 1.0)
        return
    if rule.action == "hang":
        released = _release.wait(
            rule.param if rule.param is not None else 3600.0
        )
        if released:
            raise ChaosHang(
                f"chaos: injected hang at seam '{seam}' (call {n}) "
                f"released by reset()"
            )
        return
    if rule.action == "sigterm":
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        return
