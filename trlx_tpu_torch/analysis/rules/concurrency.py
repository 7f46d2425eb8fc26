"""Concurrency-tier rules: whole-program race, deadlock, and
signal-safety checks on top of :mod:`trlx_tpu_torch.analysis.concurrency`
(port of trlx_tpu.analysis.rules.concurrency).

The lexical lock rules (rules/locks.py) are the annotation front-end:
``# guarded-by:`` names the contract, ``# holds:`` states a caller
obligation, and the per-class walker proves in-class writes. These four
rules are the whole-program back-end — they consume the thread model
(roots, contexts, interprocedural locksets, lock-order graph) and fire
only on code the model proves concurrent, so a helper only ever called
from one thread stays quiet even when it touches guarded state bare.

Scope note: the model covers ``trlx_tpu_torch/`` library files. The rules
additionally skip functions with zero computed thread contexts for the
race check (single-context code cannot race with itself), but the
lock-order and signal rules consider every acquisition the model saw —
a cycle is latent even if today only one root walks half of it.
"""

from typing import Iterable, Set

from trlx_tpu_torch.analysis import Rule, register
from trlx_tpu_torch.analysis.concurrency import NON_REENTRANT, thread_model


def _ctx_list(contexts: Set[str], cap: int = 3) -> str:
    ordered = sorted(contexts)
    shown = ", ".join(ordered[:cap])
    extra = len(ordered) - cap
    return shown + (f" (+{extra} more)" if extra > 0 else "")


@register
class RaceDetectedRule(Rule):
    id = "race-detected"
    family = "concurrency"
    rationale = (
        "the lexical guarded-by rule proves writes inside the annotated "
        "class, but trlx_tpu's three lazy-lock races all hid one hop away: "
        "a helper call, a lock taken in the caller, a read path nobody "
        "annotated. Eraser's insight (Savage, SOSP '97) is that shared "
        "state must have SOME lock held on every access from every "
        "thread; this rule applies it along the computed thread model — "
        "an access to guarded state reachable from two thread contexts "
        "with the guard not held, or a call that breaks a callee's "
        "'# holds:' contract, is a race today or after the next refactor"
    )
    hint = (
        "take 'with self.<lock>:' around the access, or declare "
        "'# holds: <lock>' on the def line and make every caller hold it"
    )

    def run(self, project) -> Iterable:
        tm = thread_model(project)
        # the lockset is a property of the STATE, not of any single
        # accessor: an attr is shared when the union of its accessors'
        # thread contexts has >= 2 roots — then EVERY access (a lone
        # reader on the worker included) must hold the guard
        attr_contexts = {}
        for fi in tm.functions.values():
            for acc in fi.accesses:
                skey = (fi.ctx.path, fi.cls.name, acc.attr)
                attr_contexts.setdefault(skey, set()).update(fi.contexts)
        for key in sorted(tm.functions):
            fi = tm.functions[key]
            # direction 1: unguarded touch of guarded-by state the model
            # proves shared (accessed from >= 2 thread contexts overall)
            for acc in fi.accesses:
                if acc.guard in acc.held or not fi.contexts:
                    continue
                shared = attr_contexts[
                    (fi.ctx.path, fi.cls.name, acc.attr)
                ]
                if len(shared) < 2:
                    continue
                yield self.finding(
                    fi.ctx, acc.line,
                    f"{acc.kind} of {fi.cls.name}.{acc.attr} "
                    f"(guarded-by {acc.guard.split('.')[-1]}) in "
                    f"{fi.qual}() without the lock; the attribute is "
                    f"reached from thread contexts: "
                    f"{_ctx_list(shared)}",
                )
            # direction 2: a call that does not satisfy the callee's
            # '# holds:' entry contract (construction-time calls exempt
            # — the object is not shared yet)
            if fi.node.name == "__init__" or not fi.contexts:
                continue
            for callee_key, line, held in fi.calls:
                callee = tm.functions.get(callee_key)
                if callee is None or not callee.entry_locks:
                    continue
                missing = callee.entry_locks - held
                if not missing:
                    continue
                yield self.finding(
                    fi.ctx, line,
                    f"{fi.qual}() calls {callee.qual}() which declares "
                    f"'# holds: "
                    f"{', '.join(l.split('.')[-1] for l in sorted(missing))}"
                    f"' — caller does not hold it (thread contexts: "
                    f"{_ctx_list(fi.contexts)})",
                )


@register
class LockOrderCycleRule(Rule):
    id = "lock-order-cycle"
    family = "concurrency"
    rationale = (
        "two locks taken in opposite orders by two threads deadlock the "
        "first time the schedules interleave — and nothing times out, "
        "because both sides are blocked in acquire, not in a seam the "
        "watchdog bounds. The model records an edge outer->inner for "
        "every nested acquisition (lexical or through a call made "
        "holding a lock); any cycle whose edges are contributed by "
        "two or more thread contexts is a deadlock-in-waiting"
    )
    hint = (
        "pick one global order for the locks in the cycle and release "
        "the outer lock before taking the inner one on the odd path "
        "(hand the work to a local, drop the lock, then act)"
    )

    def run(self, project) -> Iterable:
        tm = thread_model(project)
        for scc in tm.lock_cycles():
            in_scc = set(scc)
            edges = [
                e for e in sorted(tm.lock_edges)
                if e[0] in in_scc and e[1] in in_scc
            ]
            contexts: Set[str] = set()
            for e in edges:
                contexts.update(tm.edge_contexts(e))
            if len(contexts) < 2:
                continue  # one thread nests both ways: ugly, not deadly
            # anchor the finding on each edge's first recording site so
            # every participating acquisition shows up in the output
            for outer, inner in edges:
                key, line = tm.lock_edges[(outer, inner)][0]
                fi = tm.functions[key]
                yield self.finding(
                    fi.ctx, line,
                    f"lock-order cycle over {{{', '.join(scc)}}}: "
                    f"{fi.qual}() acquires {inner} while holding "
                    f"{outer}; another context orders them the other "
                    f"way (contexts: {_ctx_list(contexts)})",
                )


@register
class BlockingUnderSharedLockRule(Rule):
    id = "blocking-under-shared-lock"
    family = "concurrency"
    rationale = (
        "a join()/wait() without timeout, a bounded_call, or outbound "
        "HTTP made while holding a lock that a watchdog or signal path "
        "also takes turns a slow peer into a stuck liveness probe: the "
        "path that exists to detect stalls is itself parked on the "
        "lock. The drain/stop choreography in serve/ is exactly this "
        "shape — swap handles under the lock, block OUTSIDE it"
    )
    hint = (
        "copy the handle to a local under the lock, release, then "
        "join/wait/call on the local (or bound the wait with a timeout)"
    )

    def run(self, project) -> Iterable:
        tm = thread_model(project)
        shared = tm.shared_locks()
        if not shared:
            return
        for key in sorted(tm.functions):
            fi = tm.functions[key]
            for desc, line, held in fi.blocking:
                for lock in sorted(held & set(shared)):
                    yield self.finding(
                        fi.ctx, line,
                        f"{fi.qual}() blocks ({desc}) while holding "
                        f"{lock}, which the {shared[lock]} path also "
                        f"acquires",
                    )
            # interprocedural: a call made under a shared lock to a
            # function that (transitively) blocks unboundedly
            for callee_key, line, held in fi.calls:
                hot = sorted(held & set(shared))
                if not hot:
                    continue
                hit = tm.blocks_transitively(callee_key)
                if hit is None:
                    continue
                desc, where = hit
                yield self.finding(
                    fi.ctx, line,
                    f"{fi.qual}() holds {hot[0]} (shared with "
                    f"{shared[hot[0]]}) across a call that blocks: "
                    f"{where}() does {desc}",
                )


@register
class SignalUnsafeCallRule(Rule):
    id = "signal-unsafe-call"
    family = "concurrency"
    rationale = (
        "a signal handler runs on whatever frame the signal interrupts "
        "— if that frame already holds the lock the handler wants, a "
        "non-reentrant acquire self-deadlocks with no second thread "
        "involved, and thread construction inside a handler reenters "
        "interpreter state the signal may have interrupted. The vetted "
        "pattern is MetricsRegistry's RLock (reentry is a no-op) or an "
        "Event.set() handed to a poll loop; anything heavier belongs "
        "outside the handler"
    )
    hint = (
        "have the handler set a threading.Event (or telemetry.inc via "
        "the registry RLock) and do the real work from the thread that "
        "polls it"
    )

    def run(self, project) -> Iterable:
        tm = thread_model(project)
        for key in sorted(tm.functions):
            fi = tm.functions[key]
            sig = sorted(
                c for c in fi.contexts if c.startswith("signal:")
            )
            if not sig:
                continue
            ctx_note = f"reachable from {_ctx_list(set(sig))}"
            for lock, kind, line, _ in fi.acquires:
                if kind not in NON_REENTRANT:
                    continue  # RLock: the vetted registry path
                yield self.finding(
                    fi.ctx, line,
                    f"{fi.qual}() acquires non-reentrant {kind} "
                    f"{lock} on a signal path ({ctx_note}) — if the "
                    f"interrupted frame holds it, the process "
                    f"self-deadlocks",
                )
            for line in fi.thread_news:
                yield self.finding(
                    fi.ctx, line,
                    f"{fi.qual}() constructs a threading.Thread on a "
                    f"signal path ({ctx_note})",
                )
            for desc, line, _ in fi.blocking:
                yield self.finding(
                    fi.ctx, line,
                    f"{fi.qual}() makes a blocking call ({desc}) on a "
                    f"signal path ({ctx_note})",
                )
