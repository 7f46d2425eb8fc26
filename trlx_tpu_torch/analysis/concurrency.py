"""Whole-program thread model + lockset/lock-order engines for graftlint
(port of trlx_tpu.analysis.concurrency, over the port's own threads).

The serving stack is a genuinely concurrent system — HTTP handler pool,
slot-scheduler worker, supervisor watchdog, drain/watch threads, router
prober, and a SIGTERM handler all touch shared state. The lexical
``guarded-by`` rule (rules/locks.py) proves writes *inside* the
annotated class against ``with self._lock:``, but it cannot see a
mutation reached through a helper call, a lock acquired in the caller,
or two locks taken in opposite orders by two threads. This module is
the rung above: a conservative, annotation-seeded whole-program model
in the style of Eraser's lockset algorithm (Savage et al., SOSP '97)
and RacerD's compositional ownership/lockset summaries (Blackshear et
al., OOPSLA '18), sized for a stdlib AST checker:

- **Thread model.** Roots are every ``threading.Thread(target=...)``
  spawn site (named by its literal ``name=`` kwarg), every ``do_*``
  entry of a ``BaseHTTPRequestHandler`` subclass (each entry of the
  ThreadingHTTPServer pool is its own context — two entries model the
  pool's real concurrency), and every ``signal.signal(SIG, handler)``
  install (``signal:<SIG>``). A bounded-depth call-graph walk
  (self-method, module-function, imported-function, and light
  attribute-type edges) gives every function the set of root contexts
  it may run on. The model covers ``trlx_tpu_torch/`` library files only:
  test threads exercise the same functions but under test-controlled
  interleavings, and the system's own thread inventory is the contract
  being checked.
- **Lockset engine.** A lock is identified as ``Class.attr`` (assigned
  a ``threading.Lock/RLock/Condition/...`` constructor anywhere in the
  class) or ``file::NAME`` for module-level locks. The lockset at a
  statement is the lexical ``with self.<lock>:`` nest plus the
  function's ``# holds: <lock>`` entry contract; caller locksets do
  NOT flow implicitly — the ``# holds:`` contract is the propagation
  mechanism, and the race rule checks both directions (an unguarded
  access from >= 2 contexts, and a caller that breaks a callee's
  contract).
- **Lock-order graph.** Every nested acquisition adds an edge
  outer -> inner; a call made while holding locks adds edges to every
  lock the callee transitively acquires. Cycles whose edges span >= 2
  thread contexts are deadlocks-in-waiting (rules/concurrency.py).
- **Blocking + signal summaries.** Per-function lists of unbounded
  blocking calls (``join()`` / ``wait()`` without timeout,
  ``bounded_call``, outbound ``urlopen``), ``threading.Thread``
  constructions, and lock acquisitions, with the lockset held at each
  — the raw material for ``blocking-under-shared-lock`` and
  ``signal-unsafe-call``.

Known, deliberate imprecision (conservative in the quiet direction):
dynamic dispatch through callables stored in containers, ``type()``-
built subclasses, and ``getattr`` chains produce no edges, so a
function the model cannot reach simply gets no contexts and no rule
fires on it. The model never invents an edge that cannot exist.
"""

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from trlx_tpu_torch.analysis.model import FileContext, ProjectModel

#: threading constructors that make an attribute a lock
LOCK_TYPES = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")

#: lock types a signal handler may NOT acquire (an RLock already held by
#: the interrupted frame re-enters; these self-deadlock)
NON_REENTRANT = ("Lock", "Condition", "Semaphore", "BoundedSemaphore")

#: container methods that mutate in place (shared with rules/locks.py)
MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "clear",
    "add", "discard", "update", "setdefault", "sort",
})

#: callee leaves that block unboundedly unless a timeout bounds them
_TIMED_BLOCKERS = ("join", "wait", "acquire")
#: callee leaves that block for real wall-time even WITH a timeout —
#: outbound HTTP and the bounded-seam worker wait seconds, not micros
_ALWAYS_BLOCKERS = ("bounded_call", "urlopen")

#: call-graph BFS depth bound — deep enough for any real chain here
#: (handler -> server -> batcher -> runtime is 4), bounded so a cycle
#: in the (approximate) graph cannot spin
_MAX_DEPTH = 24

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _leaf(fn) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _self_attr(node) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _has_timeout(call: ast.Call) -> bool:
    """A bounding timeout: positional arg (Event.wait(5)) or timeout=."""
    if call.args:
        return True
    return _kwarg(call, "timeout") is not None


class ClassInfo:
    """Per-class metadata the engines key on."""

    __slots__ = ("name", "ctx", "node", "locks", "guarded", "attr_types",
                 "methods", "properties", "bases")

    def __init__(self, ctx: FileContext, node: ast.ClassDef):
        self.name = node.name
        self.ctx = ctx
        self.node = node
        #: lock attr -> constructor leaf ("Lock", "RLock", ...)
        self.locks: Dict[str, str] = {}
        #: guarded attr -> (guard lock attr, annotation line)
        self.guarded: Dict[str, Tuple[str, int]] = {}
        #: attr -> class-name string (from ``self.x = ClassName(...)``
        #: or a class-level ``x: "ClassName"`` annotation)
        self.attr_types: Dict[str, str] = {}
        #: method name -> function key
        self.methods: Dict[str, str] = {}
        self.properties: Set[str] = set()
        self.bases: Set[str] = {_leaf(b) for b in node.bases}
        self._scan(ctx, node)

    def _scan(self, ctx: FileContext, node: ast.ClassDef) -> None:
        for stmt in ast.walk(node):
            if isinstance(stmt, ast.AnnAssign):
                self._scan_ann(ctx, stmt)
            elif isinstance(stmt, ast.Assign):
                self._scan_assign(ctx, stmt)

    def _scan_ann(self, ctx: FileContext, stmt: ast.AnnAssign) -> None:
        attr = _self_attr(stmt.target)
        if attr is None and isinstance(stmt.target, ast.Name):
            # class-level ``server_ref: "InferenceServer" = None``
            ann = stmt.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                self.attr_types.setdefault(
                    stmt.target.id, ann.value.strip('"')
                )
            elif isinstance(ann, ast.Name):
                self.attr_types.setdefault(stmt.target.id, ann.id)
            return
        if attr is not None:
            self._note_value(ctx, attr, stmt.value, stmt.lineno)

    def _scan_assign(self, ctx: FileContext, stmt: ast.Assign) -> None:
        for t in stmt.targets:
            attr = _self_attr(t)
            if attr is not None:
                self._note_value(ctx, attr, stmt.value, stmt.lineno)

    def _note_value(self, ctx: FileContext, attr: str, value,
                    lineno: int) -> None:
        if isinstance(value, ast.Call):
            leaf = _leaf(value.func)
            if leaf in LOCK_TYPES:
                self.locks.setdefault(attr, leaf)
            elif leaf and leaf[0].isupper():
                self.attr_types.setdefault(attr, leaf)
        guard = ctx.guarded_by_on(lineno)
        if guard is not None:
            self.guarded.setdefault(attr, (guard, lineno))

    def lock_id(self, attr: str) -> str:
        return f"{self.name}.{attr}"


class Access:
    """One touch of a guarded attribute: kind is ``write`` (assignment /
    augmented / delete), ``mutate`` (in-place container method),
    ``call`` (any method call on the guarded object — the object's
    internals are only safe under the guard), or ``read``."""

    __slots__ = ("attr", "guard", "line", "kind", "held")

    def __init__(self, attr: str, guard: str, line: int, kind: str,
                 held: Set[str]):
        self.attr = attr
        self.guard = guard
        self.line = line
        self.kind = kind
        self.held = held


class FunctionInfo:
    """One function/method (nested defs are their own nodes)."""

    __slots__ = ("key", "qual", "ctx", "node", "cls", "parent",
                 "entry_locks", "nested", "calls", "acquires", "blocking",
                 "thread_news", "accesses", "contexts")

    def __init__(self, key: str, qual: str, ctx: FileContext, node,
                 cls: Optional[ClassInfo], parent: Optional[str]):
        self.key = key
        self.qual = qual
        self.ctx = ctx
        self.node = node
        self.cls = cls
        self.parent = parent
        self.entry_locks: Set[str] = set()
        self.nested: Dict[str, str] = {}
        #: (callee key, line, locks held at the call site)
        self.calls: List[Tuple[str, int, Set[str]]] = []
        #: (lock id, ctor leaf, line, locks held OUTSIDE this with)
        self.acquires: List[Tuple[str, str, int, Set[str]]] = []
        #: (description, line, locks held) for unbounded blocking calls
        self.blocking: List[Tuple[str, int, Set[str]]] = []
        #: lines constructing threading.Thread
        self.thread_news: List[int] = []
        self.accesses: List[Access] = []
        self.contexts: Set[str] = set()


class ThreadModel:
    """The whole-program model: functions, roots, contexts, lock graph.

    Build once per ProjectModel via :func:`thread_model`; the four
    concurrency rules and the ``--threads`` CLI report all read it.
    """

    def __init__(self, project: ProjectModel):
        self.project = project
        self.functions: Dict[str, FunctionInfo] = {}
        #: (path, class name) -> ClassInfo
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        #: root label -> entry function keys
        self.roots: Dict[str, List[str]] = {}
        #: lock-order edges: (outer, inner) -> [(fn key, line), ...]
        self.lock_edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
        #: lock id -> ctor leaf ("Lock"/"RLock"/...)
        self.lock_kinds: Dict[str, str] = {}
        self._module_fns: Dict[str, Dict[str, str]] = {}
        self._module_locks: Dict[str, Dict[str, str]] = {}
        self._closure_cache: Dict[str, Set[str]] = {}
        self._blocks_cache: Dict[str, bool] = {}
        #: path -> name -> (module, orig): ProjectModel.imported_from
        #: walks the whole tree per query; one walk per file instead
        self._imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._index(project)
        for fi in self.functions.values():
            self._extract(fi)
        self._find_roots()
        self._propagate_contexts()
        self._interprocedural_lock_edges()

    # -- pass 1: index every class and function ------------------------- #

    def _index(self, project: ProjectModel) -> None:
        for path, ctx in sorted(project.files.items()):
            if ctx.tree is None or not ctx.in_library:
                continue
            self._module_fns[path] = {}
            self._module_locks[path] = {}
            for stmt in ctx.tree.body:
                if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call
                ) and _leaf(stmt.value.func) in LOCK_TYPES:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            lock = f"{path}::{t.id}"
                            self._module_locks[path][t.id] = lock
                            self.lock_kinds[lock] = _leaf(stmt.value.func)
            self._index_body(ctx, ctx.tree, cls=None, parent=None,
                             prefix="")

    def _index_body(self, ctx: FileContext, node, cls: Optional[ClassInfo],
                    parent: Optional[str], prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                ci = ClassInfo(ctx, child)
                self.classes[(ctx.path, child.name)] = ci
                for attr, leaf in ci.locks.items():
                    self.lock_kinds[ci.lock_id(attr)] = leaf
                self._index_body(ctx, child, cls=ci, parent=None,
                                 prefix=f"{child.name}.")
            elif isinstance(child, _FN_NODES):
                qual = f"{prefix}{child.name}"
                key = f"{ctx.path}::{qual}"
                fi = FunctionInfo(key, qual, ctx, child, cls, parent)
                self.functions[key] = fi
                if cls is not None and parent is None:
                    cls.methods.setdefault(child.name, key)
                    for dec in child.decorator_list:
                        if _leaf(dec) == "property":
                            cls.properties.add(child.name)
                if parent is not None:
                    pfi = self.functions.get(parent)
                    if pfi is not None:
                        pfi.nested[child.name] = key
                self._index_body(ctx, child, cls=cls, parent=key,
                                 prefix=f"{qual}.<locals>.")

    # -- pass 2: per-function extraction -------------------------------- #

    def _own_nodes(self, fn_node) -> Iterable[ast.AST]:
        """Nodes belonging to this function, excluding nested def/class
        subtrees (those are their own FunctionInfo); lambdas included."""
        stack = list(ast.iter_child_nodes(fn_node))
        while stack:
            node = stack.pop()
            if isinstance(node, _FN_NODES + (ast.ClassDef,)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _entry_locks(self, fi: FunctionInfo) -> Set[str]:
        lock = fi.ctx.holds_on(fi.node.lineno)
        if lock is None:
            return set()
        if fi.cls is not None:
            return {fi.cls.lock_id(lock)}
        module_lock = self._module_locks.get(fi.ctx.path, {}).get(lock)
        return {module_lock} if module_lock else set()

    def _with_lock(self, fi: FunctionInfo, expr) -> Optional[str]:
        """``with self._lock:`` / ``with MODULE_LOCK:`` -> lock id."""
        attr = _self_attr(expr)
        if attr is not None and fi.cls is not None \
                and attr in fi.cls.locks:
            return fi.cls.lock_id(attr)
        if isinstance(expr, ast.Name):
            return self._module_locks.get(fi.ctx.path, {}).get(expr.id)
        return None

    def held_at(self, fi: FunctionInfo, node) -> Set[str]:
        """Locks held at ``node``: entry contract + lexical with-nest."""
        held = set(fi.entry_locks)
        for anc in fi.ctx.parent_chain(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    lock = self._with_lock(fi, item.context_expr)
                    if lock is not None:
                        held.add(lock)
            if anc is fi.node:
                break
        return held

    def _extract(self, fi: FunctionInfo) -> None:
        fi.entry_locks = self._entry_locks(fi)
        local_types = self._local_types(fi)
        for node in self._own_nodes(fi.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held = self.held_at(fi, node)
                for item in node.items:
                    lock = self._with_lock(fi, item.context_expr)
                    if lock is not None:
                        fi.acquires.append(
                            (lock, self.lock_kinds.get(lock, "Lock"),
                             node.lineno, held - {lock})
                        )
            elif isinstance(node, ast.Call):
                self._extract_call(fi, node, local_types)
            elif isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                # property reads run code: srv.draining is a call edge
                self._property_edge(fi, node, local_types)
            self._extract_access(fi, node)

    def _local_types(self, fi: FunctionInfo) -> Dict[str, str]:
        """``v = self.attr`` (typed attr) / ``v = ClassName(...)`` gives
        local ``v`` a class name — the one-hop inference that lets HTTP
        handler bodies (``srv = self.server_ref``) reach the server."""
        out: Dict[str, str] = {}
        for node in self._own_nodes(fi.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            attr = _self_attr(node.value)
            if attr is not None and fi.cls is not None:
                typ = fi.cls.attr_types.get(attr)
                if typ:
                    out.setdefault(t.id, typ)
            elif isinstance(node.value, ast.Call):
                leaf = _leaf(node.value.func)
                if leaf and leaf[0].isupper() and self._resolve_class(
                    fi.ctx, leaf
                ) is not None:
                    out.setdefault(t.id, leaf)
        return out

    def _imported(self, ctx: FileContext,
                  name: str) -> Optional[Tuple[str, str]]:
        """Memoized :meth:`ProjectModel.imported_from` (same walk-order
        first-binding-wins semantics, one tree walk per file)."""
        table = self._imports.get(ctx.path)
        if table is None:
            table = {}
            if ctx.tree is not None:
                for node in ast.walk(ctx.tree):
                    if isinstance(node, ast.ImportFrom) and node.module:
                        for alias in node.names:
                            table.setdefault(
                                alias.asname or alias.name,
                                (node.module, alias.name),
                            )
                    elif isinstance(node, ast.Import):
                        for alias in node.names:
                            table.setdefault(
                                alias.asname
                                or alias.name.split(".")[0],
                                (alias.name, ""),
                            )
            self._imports[ctx.path] = table
        return table.get(name)

    def _resolve_class(self, ctx: FileContext,
                       name: str) -> Optional[ClassInfo]:
        ci = self.classes.get((ctx.path, name))
        if ci is not None:
            return ci
        origin = self._imported(ctx, name)
        if origin is not None:
            module, orig = origin
            target = self.project.module_file(module)
            if target is not None and orig:
                return self.classes.get((target.path, orig))
        return None

    def _resolve_name(self, fi: FunctionInfo,
                      name: str) -> Optional[str]:
        """A bare-name callee: nested def, module function, or imported
        function -> function key."""
        cur = fi
        while cur is not None:
            if name in cur.nested:
                return cur.nested[name]
            cur = self.functions.get(cur.parent) if cur.parent else None
        local = self._module_fns.get(fi.ctx.path, {}).get(name)
        if local is None:
            key = f"{fi.ctx.path}::{name}"
            if key in self.functions:
                local = key
                self._module_fns[fi.ctx.path][name] = key
        if local is not None:
            return local
        origin = self._imported(fi.ctx, name)
        if origin is not None:
            module, orig = origin
            target = self.project.module_file(module)
            if target is not None and orig:
                key = f"{target.path}::{orig}"
                if key in self.functions:
                    return key
        return None

    def _resolve_callee(self, fi: FunctionInfo, func,
                        local_types: Dict[str, str]) -> Optional[str]:
        if isinstance(func, ast.Name):
            return self._resolve_name(fi, func.id)
        if not isinstance(func, ast.Attribute):
            return None
        value, attr = func.value, func.attr
        # self.m() -> own-class method
        if isinstance(value, ast.Name) and value.id == "self" \
                and fi.cls is not None:
            return fi.cls.methods.get(attr)
        # v.m() where v has a known class, or v is an imported module
        if isinstance(value, ast.Name):
            typ = local_types.get(value.id)
            if typ is not None:
                ci = self._resolve_class(fi.ctx, typ)
                if ci is not None:
                    return ci.methods.get(attr)
            origin = self._imported(fi.ctx, value.id)
            if origin is not None:
                module, orig = origin
                module = f"{module}.{orig}" if orig else module
                target = self.project.module_file(module)
                if target is not None:
                    key = f"{target.path}::{attr}"
                    if key in self.functions:
                        return key
            return None
        # self.attr.m() through a typed attribute
        owner = _self_attr(value)
        if owner is not None and fi.cls is not None:
            typ = fi.cls.attr_types.get(owner)
            if typ is not None:
                ci = self._resolve_class(fi.ctx, typ)
                if ci is not None:
                    return ci.methods.get(attr)
        return None

    def _resolve_target(self, fi: FunctionInfo, expr,
                        local_types: Dict[str, str]) -> Optional[str]:
        """A callable REFERENCE (Thread target=, signal handler)."""
        attr = _self_attr(expr)
        if attr is not None and fi.cls is not None:
            return fi.cls.methods.get(attr)
        if isinstance(expr, ast.Name):
            return self._resolve_name(fi, expr.id)
        if isinstance(expr, ast.Attribute):
            return self._resolve_callee(fi, expr, local_types)
        return None

    def _extract_call(self, fi: FunctionInfo, node: ast.Call,
                      local_types: Dict[str, str]) -> None:
        leaf = _leaf(node.func)
        held = self.held_at(fi, node)
        if leaf == "Thread":
            fi.thread_news.append(node.lineno)
        if leaf in _ALWAYS_BLOCKERS:
            fi.blocking.append((f"{leaf}(...)", node.lineno, held))
        elif leaf in _TIMED_BLOCKERS and not _has_timeout(node):
            # acquire() only counts when it's a lock's (otherwise it is
            # far too common a method name); join()/wait() are specific
            # enough to take on leaf name alone
            if leaf != "acquire" or (
                isinstance(node.func, ast.Attribute)
                and self._with_lock(fi, node.func.value) is not None
            ):
                fi.blocking.append(
                    (f"{leaf}() without timeout", node.lineno, held)
                )
        callee = self._resolve_callee(fi, node.func, local_types)
        if callee is not None:
            fi.calls.append((callee, node.lineno, held))

    def _property_edge(self, fi: FunctionInfo, node: ast.Attribute,
                       local_types: Dict[str, str]) -> None:
        parent = fi.ctx.parents.get(node)
        if isinstance(parent, ast.Call) and parent.func is node:
            return  # a method call — _extract_call's edge
        value, attr = node.value, node.attr
        ci: Optional[ClassInfo] = None
        if isinstance(value, ast.Name):
            if value.id == "self":
                ci = fi.cls
            else:
                typ = local_types.get(value.id)
                if typ is not None:
                    ci = self._resolve_class(fi.ctx, typ)
        else:
            owner = _self_attr(value)
            if owner is not None and fi.cls is not None:
                typ = fi.cls.attr_types.get(owner)
                if typ is not None:
                    ci = self._resolve_class(fi.ctx, typ)
        if ci is None or attr not in ci.properties:
            return
        key = ci.methods.get(attr)
        if key is not None:
            fi.calls.append((key, node.lineno, self.held_at(fi, node)))

    def _extract_access(self, fi: FunctionInfo, node) -> None:
        """Touches of guarded-by-annotated attrs in the owning class."""
        if fi.cls is None or not fi.cls.guarded \
                or fi.node.name == "__init__":
            return
        guarded = fi.cls.guarded

        def note(attr: Optional[str], kind: str, line: int) -> None:
            if attr is None or attr not in guarded:
                return
            guard_attr = guarded[attr][0]
            if guard_attr not in fi.cls.locks:
                return  # guarded-by-unknown's problem, not a lockset's
            fi.accesses.append(Access(
                attr, fi.cls.lock_id(guard_attr), line, kind,
                self.held_at(fi, node),
            ))

        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for el in self._flat(t):
                    attr = _self_attr(el)
                    if attr is None and isinstance(el, ast.Subscript):
                        attr = _self_attr(el.value)
                    note(attr, "write", node.lineno)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None and isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                note(attr, "write", node.lineno)
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            attr = _self_attr(node.func.value)
            if attr is not None:
                kind = "mutate" if node.func.attr in MUTATORS else "call"
                note(attr, kind, node.lineno)
        elif isinstance(node, ast.Attribute) and isinstance(
            node.ctx, ast.Load
        ):
            # plain read — skip when it's the object of a method call
            # (counted above) or of a deeper attribute chain
            parent = fi.ctx.parents.get(node)
            if isinstance(parent, ast.Attribute):
                return
            if isinstance(parent, ast.Call) and parent.func is node:
                return
            note(_self_attr(node), "read", node.lineno)

    def _flat(self, target):
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                yield from self._flat(el)
        elif isinstance(target, ast.Starred):
            yield from self._flat(target.value)
        else:
            yield target

    # -- pass 3: thread roots -------------------------------------------- #

    def _find_roots(self) -> None:
        for fi in sorted(self.functions.values(), key=lambda f: f.key):
            local_types = self._local_types(fi)
            for node in self._own_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                leaf = _leaf(node.func)
                if leaf == "Thread":
                    target = _kwarg(node, "target")
                    if target is None:
                        continue
                    entry = self._resolve_target(fi, target, local_types)
                    if entry is None:
                        continue
                    name = _kwarg(node, "name")
                    label = (
                        name.value
                        if isinstance(name, ast.Constant)
                        and isinstance(name.value, str)
                        else f"thread@{fi.ctx.path}:{node.lineno}"
                    )
                    self.roots.setdefault(label, []).append(entry)
                elif leaf == "signal" and len(node.args) == 2:
                    entry = self._resolve_target(
                        fi, node.args[1], local_types
                    )
                    if entry is None:
                        continue
                    signame = _leaf(node.args[0]) or "?"
                    self.roots.setdefault(
                        f"signal:{signame}", []
                    ).append(entry)
        # HTTP handler pool: every do_* of a BaseHTTPRequestHandler
        # subclass is a pool entry (one context per entry — the pool
        # runs entries concurrently, so two entries model that)
        for (path, name), ci in sorted(self.classes.items()):
            if not self._is_http_handler(ci):
                continue
            for mname, key in sorted(ci.methods.items()):
                if mname.startswith("do_"):
                    self.roots.setdefault(
                        f"http:{name}.{mname}", []
                    ).append(key)

    def _is_http_handler(self, ci: ClassInfo) -> bool:
        if "BaseHTTPRequestHandler" in ci.bases:
            return True
        for base in ci.bases:
            parent = self._resolve_class(ci.ctx, base)
            if parent is not None \
                    and "BaseHTTPRequestHandler" in parent.bases:
                return True
        return False

    # -- pass 4: context propagation ------------------------------------- #

    def _propagate_contexts(self) -> None:
        for label, entries in sorted(self.roots.items()):
            seen: Set[str] = set()
            frontier = [e for e in entries if e in self.functions]
            depth = 0
            while frontier and depth < _MAX_DEPTH:
                nxt: List[str] = []
                for key in frontier:
                    if key in seen:
                        continue
                    seen.add(key)
                    fi = self.functions.get(key)
                    if fi is None:
                        continue
                    fi.contexts.add(label)
                    nxt.extend(c for c, _, _ in fi.calls)
                    nxt.extend(fi.nested.values())
                frontier = nxt
                depth += 1

    # -- pass 5: lock-order edges ----------------------------------------- #

    def locks_closure(self, key: str) -> Set[str]:
        """Locks ``key`` (or anything it transitively calls) acquires."""
        cached = self._closure_cache.get(key)
        if cached is not None:
            return cached
        self._closure_cache[key] = set()  # cycle guard
        out: Set[str] = set()
        fi = self.functions.get(key)
        if fi is not None:
            out.update(lock for lock, _, _, _ in fi.acquires)
            for callee, _, _ in fi.calls:
                out.update(self.locks_closure(callee))
            for nested in fi.nested.values():
                out.update(self.locks_closure(nested))
        self._closure_cache[key] = out
        return out

    def blocks_transitively(self, key: str,
                            _depth: int = 0) -> Optional[Tuple[str, str]]:
        """(blocker description, function qual) when ``key`` or a callee
        makes an unbounded blocking call with no extra lock discipline;
        None otherwise."""
        if _depth > _MAX_DEPTH:
            return None
        cached = self._blocks_cache.get(key)
        if cached is not None:
            return None if cached is False else cached  # type: ignore
        self._blocks_cache[key] = False  # cycle guard
        fi = self.functions.get(key)
        if fi is None:
            return None
        if fi.blocking:
            hit = (fi.blocking[0][0], fi.qual)
            self._blocks_cache[key] = hit  # type: ignore
            return hit
        for callee, _, _ in fi.calls:
            hit = self.blocks_transitively(callee, _depth + 1)
            if hit is not None:
                self._blocks_cache[key] = hit  # type: ignore
                return hit
        return None

    def _add_edge(self, outer: str, inner: str, key: str,
                  line: int) -> None:
        if outer == inner:
            return  # reentrancy / same-lock nesting is not an ORDER bug
        self.lock_edges.setdefault((outer, inner), []).append((key, line))

    def _interprocedural_lock_edges(self) -> None:
        for fi in sorted(self.functions.values(), key=lambda f: f.key):
            for lock, _, line, held in fi.acquires:
                for outer in held:
                    self._add_edge(outer, lock, fi.key, line)
            for callee, line, held in fi.calls:
                if not held:
                    continue
                for inner in self.locks_closure(callee):
                    for outer in held:
                        self._add_edge(outer, inner, fi.key, line)

    # -- queries for the rules -------------------------------------------- #

    def edge_contexts(self, edge: Tuple[str, str]) -> Set[str]:
        out: Set[str] = set()
        for key, _ in self.lock_edges.get(edge, ()):
            fi = self.functions.get(key)
            if fi is not None:
                out.update(fi.contexts)
        return out

    def lock_cycles(self) -> List[List[str]]:
        """Elementary cycles in the lock-order graph (Tarjan SCCs, then
        one representative cycle per SCC), sorted for determinism."""
        adj: Dict[str, Set[str]] = {}
        for outer, inner in self.lock_edges:
            adj.setdefault(outer, set()).add(inner)
            adj.setdefault(inner, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # iterative Tarjan: (node, child-iterator) work stack
            work = [(v, iter(sorted(adj.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(sorted(scc))

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        return sorted(sccs)

    def shared_locks(self) -> Dict[str, str]:
        """Lock id -> the watchdog/signal root that acquires it: the
        locks a blocking call must never be made under, because the
        path that needs to stay live also takes them."""
        out: Dict[str, str] = {}
        for label in sorted(self.roots):
            if not (label.startswith("signal:") or "watchdog" in label):
                continue
            for fi in sorted(self.functions.values(),
                             key=lambda f: f.key):
                if label not in fi.contexts:
                    continue
                for lock, _, _, _ in fi.acquires:
                    out.setdefault(lock, label)
        return out

    # -- the --threads report --------------------------------------------- #

    def report(self) -> str:
        lines = [
            f"thread model: {len(self.roots)} roots over "
            f"{len(self.functions)} functions",
        ]
        for label in sorted(self.roots):
            reachable = sorted(
                (fi for fi in self.functions.values()
                 if label in fi.contexts),
                key=lambda f: f.key,
            )
            locks: Set[str] = set()
            for fi in reachable:
                locks.update(lock for lock, _, _, _ in fi.acquires)
            entries = ", ".join(
                self.functions[e].qual for e in self.roots[label]
                if e in self.functions
            )
            lines.append(f"\n[{label}] entry: {entries}")
            lines.append(
                f"  locks: {', '.join(sorted(locks)) or '(none)'}"
            )
            for fi in reachable:
                lines.append(f"  - {fi.qual}  ({fi.ctx.path})")
        return "\n".join(lines)


def thread_model(project: ProjectModel) -> ThreadModel:
    """The cached whole-program model for ``project`` (built once; all
    four concurrency rules and the CLI ``--threads`` report share it)."""
    tm = getattr(project, "_thread_model", None)
    if tm is None:
        tm = ThreadModel(project)
        project._thread_model = tm
    return tm
