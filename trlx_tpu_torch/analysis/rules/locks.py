"""Lock-discipline rules (port of trlx_tpu.analysis.rules.locks).

Convention: shared state carries a ``# guarded-by: <lock>`` comment on
the line that first assigns it (normally ``__init__``); the checker
then proves every write to that attribute inside the class sits under
``with self.<lock>:``. Methods whose CALLER holds the lock carry
``# holds: <lock>`` on their ``def`` line. ``__init__`` is exempt —
construction happens before the object is shared.

Seeded onto SlotScheduler (``_cond``), PageAllocator, InferenceServer
and MetricsRegistry — the four objects touched concurrently by the
scheduler worker, the HTTP edge, drain/watch threads and (for the
registry) signal handlers.
"""

import ast
from typing import Dict, Iterable, Optional, Set

from trlx_tpu_torch.analysis import Rule, register
from trlx_tpu_torch.analysis.model import FileContext

_LOCK_TYPES = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")

#: container methods that mutate in place — a write for guarded-by
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "clear",
    "add", "discard", "update", "setdefault", "sort",
})


def _self_attr(node) -> Optional[str]:
    """``self.X`` -> "X" (one level only)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_ctor(expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    fn = expr.func
    leaf = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else ""
    )
    return leaf in _LOCK_TYPES


def _method_of(ctx: FileContext, node,
               cls: ast.ClassDef) -> Optional[ast.FunctionDef]:
    """The method of ``cls`` lexically containing ``node`` (the nearest
    enclosing function whose own parent chain reaches ``cls`` without
    passing another class)."""
    fn = ctx.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    while fn is not None:
        anc = ctx.enclosing(fn, (ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
        if anc is cls:
            return fn
        if isinstance(anc, ast.ClassDef):
            return None  # inner class
        fn = anc
    return None


def _holds_lock(ctx: FileContext, node, lock: str) -> bool:
    """Is ``node`` under ``with self.<lock>:`` (any item of any
    enclosing with-statement)?"""
    for anc in ctx.parent_chain(node):
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            if _self_attr(item.context_expr) == lock:
                return True
    return False


class ClassRule(Rule):
    """Base: fan out over every ClassDef in library files."""

    def run(self, project) -> Iterable:
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    yield from self.check_class(ctx, node)

    def check_class(self, ctx: FileContext, cls: ast.ClassDef):
        raise NotImplementedError


@register
class LazyLockRule(ClassRule):
    id = "lazy-lock"
    family = "locks"
    rationale = (
        "creating self._lock on first use is itself a race: two "
        "threads hitting the None check together each construct a "
        "Lock and serialise against DIFFERENT objects — the exact bug "
        "serve/engine.py shipped (lock built lazily in decode() while "
        "batcher.request_swap raced the same check from the reload "
        "thread)"
    )
    hint = "construct the lock eagerly in __init__"

    def check_class(self, ctx, cls):
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not _is_lock_ctor(node.value):
                continue
            attr = None
            for t in node.targets:
                attr = attr or _self_attr(t)
            if attr is None:
                continue
            fn = _method_of(ctx, node, cls)
            if fn is None or fn.name == "__init__":
                continue
            yield self.finding(
                ctx, node.lineno,
                f"self.{attr} lock constructed lazily in "
                f"{cls.name}.{fn.name}() — two first-callers can each "
                f"build one and hold different locks",
            )


def _annotations(ctx: FileContext,
                 cls: ast.ClassDef) -> Dict[str, int]:
    """attr -> annotation line for every ``# guarded-by:`` comment on a
    ``self.X = ...`` line in the class (value is the LINE; the lock
    name comes from guarded_by_on)."""
    out: Dict[str, int] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [
            node.target
        ]
        for t in targets:
            attr = _self_attr(t)
            if attr is None:
                continue
            if ctx.guarded_by_on(node.lineno) is not None:
                out.setdefault(attr, node.lineno)
    return out


def _assigned_attrs(cls: ast.ClassDef) -> Set[str]:
    out = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    out.add(attr)
    return out


@register
class GuardedByRule(ClassRule):
    id = "guarded-by"
    family = "locks"
    rationale = (
        "an attribute marked '# guarded-by: <lock>' is shared state "
        "with a locking contract; a write outside 'with self.<lock>:' "
        "is a data race the comment was pretending to prevent — the "
        "checker turns the comment into a proof obligation"
    )
    hint = (
        "wrap the write in 'with self.<lock>:', or mark the method "
        "'# holds: <lock>' if every caller provably holds it"
    )

    def check_class(self, ctx, cls):
        guards = _annotations(ctx, cls)
        if not guards:
            return
        locks = {a: ctx.guarded_by_on(line) for a, line in guards.items()}
        for node in ast.walk(cls):
            for attr, wline in self._writes(node):
                lock = locks.get(attr)
                if lock is None:
                    continue
                fn = _method_of(ctx, node, cls)
                if fn is None or fn.name == "__init__":
                    continue
                if ctx.holds_on(fn.lineno) == lock:
                    continue
                if _holds_lock(ctx, node, lock):
                    continue
                yield self.finding(
                    ctx, wline,
                    f"write to {cls.name}.{attr} (guarded-by {lock}) "
                    f"outside 'with self.{lock}:' in {fn.name}()",
                )

    def _writes(self, node):
        """(attr, line) for each write this single node performs."""
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                for leaf in self._flatten(t):
                    attr = _self_attr(leaf)
                    if attr is None and isinstance(leaf, ast.Subscript):
                        attr = _self_attr(leaf.value)
                    if attr is not None:
                        yield attr, node.lineno
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                if attr is not None:
                    yield attr, node.lineno
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                attr = _self_attr(fn.value)
                if attr is not None:
                    yield attr, node.lineno

    def _flatten(self, target):
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                yield from self._flatten(el)
        elif isinstance(target, ast.Starred):
            yield from self._flatten(target.value)
        else:
            yield target


@register
class GuardedByUnknownRule(ClassRule):
    id = "guarded-by-unknown"
    family = "locks"
    rationale = (
        "a guarded-by annotation naming a lock the class never assigns "
        "is a typo that silently disables the whole contract — the "
        "checker would be proving writes against a lock that does not "
        "exist"
    )
    hint = (
        "name an attribute assigned in the class (e.g. _lock, _cond)"
    )

    def check_class(self, ctx, cls):
        guards = _annotations(ctx, cls)
        if not guards:
            return
        assigned = _assigned_attrs(cls)
        for attr, line in sorted(guards.items(), key=lambda kv: kv[1]):
            lock = ctx.guarded_by_on(line)
            if lock not in assigned:
                yield self.finding(
                    ctx, line,
                    f"'# guarded-by: {lock}' on {cls.name}.{attr}: no "
                    f"'self.{lock}' is ever assigned in the class",
                )
