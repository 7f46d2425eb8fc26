"""Style rules (port of trlx_tpu.analysis.rules.style).

The highest-signal subset of the configured ruff rules (pyproject
[tool.ruff]) plus the library-only conventions, as registry rules that
share one engine, one suppression syntax, and one catalog with the
invariant families. Every path scope names the port's package
(``trlx_tpu_torch/...``); the pytest bridge is tests/test_torch_style.py
(``test_torch_lint[<path>]``).
"""

import ast
from typing import Iterable, Set

from trlx_tpu_torch.analysis import Finding, ProjectModel, Rule, register
from trlx_tpu_torch.analysis.model import LIB, FileContext


def _used_names(tree: ast.AST) -> Set[str]:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    # __all__ strings count as uses (re-export shims)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, str
                        ):
                            used.add(el.value)
    return used


class FileRule(Rule):
    """Base for per-file rules: ``run`` fans out over parsed files."""

    def run(self, project: ProjectModel) -> Iterable[Finding]:
        for ctx in project.files.values():
            if ctx.tree is None:
                continue
            if self.applies(ctx):
                yield from self.check(ctx, project)

    def applies(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext,
              project: ProjectModel) -> Iterable[Finding]:
        raise NotImplementedError


@register
class SyntaxErrorRule(Rule):
    id = "syntax-error"
    family = "style"
    rationale = (
        "a file that does not parse is invisible to every other rule "
        "and to python itself; nothing downstream can be trusted"
    )
    hint = "fix the syntax error; the message carries the parser detail"

    def run(self, project):
        for ctx in project.files.values():
            if ctx.syntax_error is not None:
                e = ctx.syntax_error
                yield self.finding(
                    ctx, e.lineno or 1, f"does not parse: {e.msg}"
                )


@register
class UnusedImportRule(FileRule):
    id = "unused-import"
    family = "style"
    rationale = (
        "ruff F401 without needing ruff installed: dead imports hide "
        "real dependencies and mask copy-paste drift"
    )
    hint = (
        "delete the import (or '# noqa' a deliberate re-export shim)"
    )

    def check(self, ctx, project):
        used = _used_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if getattr(node, "module", "") == "__future__":
                continue
            if "noqa" in ctx.lines[node.lineno - 1]:
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                bound = (alias.asname or alias.name).split(".")[0]
                if bound not in used:
                    yield self.finding(
                        ctx, node.lineno,
                        f"unused import '{bound}' (F401)",
                    )


@register
class NoneComparisonRule(FileRule):
    id = "none-comparison"
    family = "style"
    rationale = (
        "ruff E711: '== None' silently diverges from 'is None' for "
        "objects with __eq__ (numpy arrays return elementwise masks)"
    )
    hint = "use 'is None' / 'is not None'"

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Compare):
                continue
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)) and (
                    isinstance(comp, ast.Constant) and comp.value is None
                ):
                    yield self.finding(
                        ctx, node.lineno,
                        "comparison to None with ==/!= (E711)",
                    )


@register
class WhitespaceRule(FileRule):
    id = "trailing-whitespace"
    family = "style"
    rationale = "W291: trailing whitespace churns diffs and reviews"
    hint = "strip it (most editors do this on save)"

    def check(self, ctx, project):
        for i, line in enumerate(ctx.lines, 1):
            if line != line.rstrip():
                yield self.finding(ctx, i, "trailing whitespace (W291)")


@register
class TabIndentRule(FileRule):
    id = "tab-indent"
    family = "style"
    rationale = (
        "W191: mixed tab/space indentation is a latent IndentationError "
        "and renders differently everywhere"
    )
    hint = "indent with spaces"

    def check(self, ctx, project):
        for i, line in enumerate(ctx.lines, 1):
            indent = line[: len(line) - len(line.lstrip())]
            if "\t" in indent:
                yield self.finding(ctx, i, "tab in indentation (W191)")


@register
class BareExceptRule(FileRule):
    id = "bare-except"
    family = "style"
    rationale = (
        "E722, library-only: the reference's checkpointing wrapped "
        "everything in try/except and shipped dead without anyone "
        "noticing (SURVEY §3.6); a handler must name what it catches"
    )
    hint = "name the exception type(s) being handled"

    def applies(self, ctx):
        return ctx.in_library

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield self.finding(
                    ctx, node.lineno,
                    "bare 'except:' (E722) — name the exception; the "
                    "reference's swallowed-exception checkpointing is "
                    "the bug class this forbids",
                )


@register
class SwallowedExceptionRule(FileRule):
    id = "swallowed-exception"
    family = "style"
    rationale = (
        "library-only: 'except ...: pass' is how the reference's "
        "checkpointing shipped dead (SURVEY §3.6) — a handler must DO "
        "something with the failure"
    )
    hint = "re-raise, return a fallback, or log the failure"

    def applies(self, ctx):
        return ctx.in_library

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is not None:
                if all(isinstance(s, ast.Pass) for s in node.body):
                    yield self.finding(
                        ctx, node.lineno,
                        "exception-swallowing 'except ...: pass'",
                    )


#: modules whose job IS timing: Clock, the telemetry registry/tracer,
#: the supervisor (its timing is the supervision mechanism and surfaces
#: as fault/* counters), and this linter's own CLI (a dev tool with no
#: metrics stream to reach)
_TIMING_ALLOWED_PREFIXES = (
    LIB + "telemetry/",
    LIB + "supervisor/",
    LIB + "analysis/",
)
_TIMING_ALLOWED_FILES = (LIB + "utils/__init__.py",)
_TIME_FNS = ("time", "perf_counter", "monotonic")


@register
class AdhocTimingRule(FileRule):
    id = "adhoc-timing"
    family = "style"
    rationale = (
        "library-only: ad-hoc time.time()/perf_counter() deltas are the "
        "opaque instrumentation the unified telemetry layer replaced — "
        "a measurement that dies in a local variable never reaches the "
        "metrics stream (docs 'Observability')"
    )
    hint = (
        "use trlx_tpu_torch.telemetry.span()/observe() (or utils.Clock / "
        "supervisor.monotonic for control-flow deadlines)"
    )

    def applies(self, ctx):
        return (
            ctx.in_library
            and ctx.path not in _TIMING_ALLOWED_FILES
            and not ctx.path.startswith(_TIMING_ALLOWED_PREFIXES)
        )

    def check(self, ctx, project):
        # names bound by `from time import ...` (the evasion a plain
        # attribute check would miss)
        from_time = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in _TIME_FNS:
                        from_time.add(alias.asname or alias.name)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = None
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _TIME_FNS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time"
            ):
                hit = f"time.{node.func.attr}"
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in from_time
            ):
                hit = node.func.id
            if hit:
                yield self.finding(
                    ctx, node.lineno, f"ad-hoc {hit}() timing"
                )


@register
class ServeClockRule(FileRule):
    id = "serve-clock"
    family = "style"
    rationale = (
        "serve-path only: request traces do arithmetic across "
        "timestamps stamped by different threads (HTTP edge, scheduler "
        "worker) — sound only if every one comes from the SAME clock, "
        "supervisor.monotonic. Banning the time/datetime modules "
        "outright keeps a mixed-clock TTFT from arriving via an "
        "innocent import (see trlx_tpu_torch/serve/trace.py)"
    )
    hint = (
        "source serve timestamps from trlx_tpu_torch.supervisor.monotonic"
    )

    def applies(self, ctx):
        return ctx.in_serve

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            banned = None
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] in ("time", "datetime"):
                        banned = alias.name
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] in (
                    "time", "datetime"
                ):
                    banned = node.module
            if banned:
                yield self.finding(
                    ctx, node.lineno,
                    f"serve-path import of '{banned}' — serve code "
                    f"records wall-clock times only via "
                    f"trlx_tpu_torch.supervisor.monotonic",
                )
