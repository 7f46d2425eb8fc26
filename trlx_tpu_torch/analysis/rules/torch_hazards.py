"""Torch hazard rules: host syncs and wrapper churn around ``aot_jit``
(the counterpart of trlx_tpu.analysis.rules.jax_hazards, with its rule
ids, in family ``torch``).

The port's ``aot_jit`` (trlx_tpu_torch.utils.aotjit) captures one CUDA
graph per argument signature and replays it, with a contract that only
the card enforces: no host sync inside the captured function, and one
cache per wrapper. A ``.item()`` there breaks the capture (CUDA refuses
a device-to-host copy while a stream captures), or, where it survives
eagerly on the CPU, stalls the replayed step; a wrapper built in a loop
starts a fresh graph cache on every iteration, so the steady state
captures again and again (``compile/recompiles`` stays 0 while every
call pays a capture).

trlx_tpu's third rule, ``use-after-donate``, has no counterpart: the
port's ``aot_jit`` takes no donation argument (a replay writes the
captured tensors in place), so no buffer dies at a call.
"""

import ast
from typing import List, Optional, Set

from trlx_tpu_torch.analysis import Rule, register
from trlx_tpu_torch.analysis.model import FileContext

#: spellings of the port's graph-cache wrapper (module attr or bare
#: import)
_JIT_NAMES = ("aot_jit",)

#: tensor methods that read a device value back to the host
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

#: attribute accesses and calls that are static metadata, not device
#: data (``x.size(0)``, ``x.shape[1]``, ``x.numel()``)
_STATIC_ATTRS = ("shape", "dtype", "ndim", "size", "device", "numel",
                 "dim", "is_cuda")

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted(node) -> Optional[str]:
    """``torch.cuda.synchronize`` -> that string, ``x`` -> "x"; None
    otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        if base is not None:
            return f"{base}.{node.attr}"
    return None


def _call_name(node: ast.Call) -> str:
    """Last path component of the callee: ``aotjit.aot_jit`` -> "aot_jit"."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_jit_call(node: ast.Call) -> bool:
    return _call_name(node) in _JIT_NAMES


def _scope_of(ctx: FileContext, node) -> ast.AST:
    fn = ctx.enclosing(node, _SCOPES)
    return fn if fn is not None else ctx.tree


def _defs_in(ctx: FileContext, scope) -> dict:
    """name -> def for the functions defined directly in ``scope`` (a
    function's body, or the module's top level; methods are not
    reachable by a bare name, so class bodies are skipped)."""
    out = {}
    for node in ast.walk(scope):
        if node is scope or not isinstance(node, _SCOPES):
            continue
        parent = ctx.parents.get(node)
        if isinstance(parent, ast.ClassDef):
            continue
        if _scope_of(ctx, node) is scope:
            out.setdefault(node.name, node)
    return out


def _resolve(ctx: FileContext, call: ast.Call, name: str):
    """The def a bare name passed at ``call`` refers to: the nearest
    enclosing function scope that defines it, else the module's."""
    scope = _scope_of(ctx, call)
    while True:
        found = _defs_in(ctx, scope).get(name)
        if found is not None:
            return found
        if scope is ctx.tree:
            return None
        scope = _scope_of(ctx, scope)


def _jitted_functions(ctx: FileContext) -> List[ast.FunctionDef]:
    """Functions behind ``aot_jit``: decorated with it (bare or
    ``partial(aot_jit, ...)``), or passed to it by name (resolved
    lexically from the call, so a module-level step wrapped inside a
    method's ``__init__`` is found, and a method sharing its name is
    not)."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _is_jit_call(node):
            if node.args and isinstance(node.args[0], ast.Name):
                fn = _resolve(ctx, node, node.args[0].id)
                if fn is not None and fn not in out:
                    out.append(fn)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, _SCOPES) or node in out:
            continue
        for dec in node.decorator_list:
            target = dec
            if isinstance(dec, ast.Call):
                if _call_name(dec) == "partial" and dec.args:
                    target = dec.args[0]
                else:
                    target = dec.func
            name = _dotted(target) or ""
            if name.split(".")[-1] in _JIT_NAMES:
                out.append(node)
                break
    return out


def _params(fn) -> Set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _rooted_in(ctx: FileContext, expr, params: Set[str], stop) -> bool:
    """Does ``expr`` reach tensor data rooted at a parameter? Paths
    through static metadata (``.shape``, ``.size(0)``, ``.dtype``...)
    don't count — ``int(x.shape[0])`` is host-side and fine."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Name) or node.id not in params:
            continue
        static = False
        cur = node
        while cur is not stop:
            parent = ctx.parents.get(cur)
            if parent is None:
                break
            if isinstance(parent, ast.Attribute) and (
                parent.attr in _STATIC_ATTRS
            ):
                static = True
                break
            cur = parent
        if not static:
            return True
    return False


@register
class HostSyncInJitRule(Rule):
    id = "host-sync-in-jit"
    family = "torch"
    rationale = (
        "a function behind aot_jit is captured as a CUDA graph on the "
        "card: .item()/.tolist()/.cpu()/.numpy(), float()/int() on a "
        "tensor, or torch.cuda.synchronize() inside it is a "
        "device-to-host read that CUDA refuses while a stream captures "
        "(the capture breaks, nothing falls back to eager), and that "
        "stalls the step where it runs eagerly — the CPU tests run the "
        "same function and never see it"
    )
    hint = (
        "keep the math on the device (torch ops, in-place updates of the "
        "arguments); read values back only outside the captured "
        "function (shape/dtype metadata is fine as-is)"
    )

    def run(self, project):
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            for fn in _jitted_functions(ctx):
                yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: FileContext, fn):
        params = _params(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func) or ""
            leaf = callee.split(".")[-1] if callee else _call_name(node)
            if callee.endswith("cuda.synchronize") or callee == "synchronize":
                yield self.finding(
                    ctx, node.lineno,
                    f"torch.cuda.synchronize() inside aot_jit-captured "
                    f"'{fn.name}' — a device-wide wait in a capture",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
                and not node.args
            ):
                yield self.finding(
                    ctx, node.lineno,
                    f".{node.func.attr}() inside aot_jit-captured "
                    f"'{fn.name}' — host sync on a captured tensor",
                )
            elif leaf in ("float", "int") and callee in ("float", "int"):
                if node.args and _rooted_in(
                    ctx, node.args[0], params, stop=node
                ):
                    yield self.finding(
                        ctx, node.lineno,
                        f"{callee}() on a tensor inside aot_jit-captured "
                        f"'{fn.name}'",
                    )


@register
class JitInLoopRule(Rule):
    id = "jit-in-loop"
    family = "torch"
    rationale = (
        "aot_jit() inside a loop body builds a NEW wrapper (and graph "
        "cache) per iteration, so every call captures a fresh CUDA graph "
        "— and a fresh graph memory pool — where the serve path's "
        "compile/recompiles == 0 invariant expects one capture per "
        "signature for the life of the process"
    )
    hint = (
        "hoist the aot_jit() call out of the loop and reuse the "
        "returned callable (or key a dict of wrappers by the loop's "
        "shape, as the slot runtime keys its prefill buckets)"
    )

    def run(self, project):
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) or not _is_jit_call(node):
                    continue
                loop = ctx.enclosing(node, (ast.For, ast.While))
                if loop is None:
                    continue
                # a nested def wrapping per *call* is a different story;
                # only flag when the loop is in the same function
                if _scope_of(ctx, node) is not _scope_of(ctx, loop):
                    continue
                yield self.finding(
                    ctx, node.lineno,
                    f"{_call_name(node)}() constructed inside a loop "
                    f"(line {loop.lineno}) — fresh graph cache every "
                    f"iteration",
                )
