"""graftlint's view of the port: parsed files + a light project model
(port of trlx_tpu.analysis.model).

Two layers:

- :class:`FileContext` — one parsed file: source, AST, a child->parent
  map (rules ask "is this write inside a ``with self._lock:``?" by
  walking up), and the file's ``# lint: disable=`` suppressions.
- :class:`ProjectModel` — every target file plus the docs tree, with the
  cross-file resolution rules need: module-path -> file, import-alias ->
  defining module, module-level string-tuple constants (predeclared
  metric lists), and the test corpus (chaos-seam and kernel coverage).

The lint surface is the port's own: ``trlx_tpu_torch/`` and
``chip_smoke.py``. The port's tests (``tests/test_torch_*.py`` and
``tests/torch_*_worker.py``) are the test corpus the contract rules
read, and ``docs/source/*.rst`` the docs corpus; neither is linted here.
``tests/`` is trlx_tpu.analysis's to lint (tests/test_style.py), so no
file is checked by both linters.

The model is build-once, read-many: ``ProjectModel.from_repo`` parses
the port in one pass (~100 files, well under a second) and every rule
walks the shared ASTs. Tests construct tiny in-memory models
(``ProjectModel(files={...}, docs={...})``) with synthetic relpaths, so
a fixture exercises path-scoped rules (``trlx_tpu_torch/serve/...``)
without touching the real tree; a ``tests/...`` path there joins the
test corpus, as the port's test files do in the real model.
"""

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: the package this linter guards: the library-only rules scope to it
PACKAGE = "trlx_tpu_torch"
LIB = PACKAGE + "/"

#: the port's lint surface; fixture snippets under tests/lint_fixtures/
#: are planted-bad by design and excluded everywhere
TARGET_ROOTS = (PACKAGE,)
TARGET_FILES = ("chip_smoke.py",)
EXCLUDE_PARTS = ("lint_fixtures", "__pycache__", "_scratch")

#: the port's tests: the test corpus, read and never linted here
TEST_GLOBS = ("tests/test_torch_*.py", "tests/torch_*_worker.py")
TESTS = "tests/"

#: the metric catalog the contract-sync rules check names against: the
#: reference's, and the port's own page for the names the port adds
OBSERVABILITY_DOC = "docs/source/observability.rst"
PORT_OBSERVABILITY_DOC = "docs/source/torch_observability.rst"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"\s*(?:--\s*(?P<why>.*\S))?\s*$"
)
_HOLDS_RE = re.compile(r"#\s*holds:\s*(?P<lock>[A-Za-z_][A-Za-z0-9_]*)")
_GUARDED_RE = re.compile(
    r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][A-Za-z0-9_]*)"
)


class Suppression:
    """One ``# lint: disable=<rule>[,rule...] -- <justification>``.

    ``line`` is the line the comment sits on; it applies to findings on
    that line and — when the comment is the whole line — to the next
    line, so long statements can carry their waiver above themselves.
    A suppression without a justification does not suppress anything;
    the engine reports it (rule ``bad-suppression``) instead.
    """

    __slots__ = ("line", "rules", "justification", "standalone", "used")

    def __init__(self, line: int, rules: Set[str], justification: str,
                 standalone: bool):
        self.line = line
        self.rules = rules
        self.justification = justification
        self.standalone = standalone
        self.used = False

    def covers(self, line: int, rule: str) -> bool:
        if rule not in self.rules:
            return False
        if line == self.line:
            return True
        return self.standalone and line == self.line + 1


def parse_suppressions(lines: List[str]) -> List[Suppression]:
    out = []
    for i, line in enumerate(lines, 1):
        m = _SUPPRESS_RE.search(line)
        if m is None:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        out.append(Suppression(
            i, rules, (m.group("why") or "").strip(),
            standalone=line.strip().startswith("#"),
        ))
    return out


class FileContext:
    """One target file: path, source, AST (or the syntax error), the
    parent map, and suppressions. ``path`` is repo-relative and is what
    every Finding carries."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.syntax_error: Optional[SyntaxError] = None
        self.parents: Dict[ast.AST, ast.AST] = {}
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:
            self.syntax_error = e
        if self.tree is not None:
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self.parents[child] = node
        self.suppressions = parse_suppressions(self.lines)

    # -- navigation ----------------------------------------------------- #

    def parent_chain(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        for anc in self.parent_chain(node):
            if isinstance(anc, kinds):
                return anc
        return None

    def line_comment_match(self, lineno: int, regex) -> Optional[str]:
        if 1 <= lineno <= len(self.lines):
            m = regex.search(self.lines[lineno - 1])
            if m is not None:
                return m.group("lock")
        return None

    def guarded_by_on(self, lineno: int) -> Optional[str]:
        return self.line_comment_match(lineno, _GUARDED_RE)

    def holds_on(self, lineno: int) -> Optional[str]:
        return self.line_comment_match(lineno, _HOLDS_RE)

    # -- scoping -------------------------------------------------------- #

    @property
    def in_library(self) -> bool:
        return self.path.startswith(LIB)

    @property
    def in_serve(self) -> bool:
        return self.path.startswith(LIB + "serve/")

    @property
    def in_tests(self) -> bool:
        return self.path.startswith(TESTS)


def _iter_target_paths(root: pathlib.Path) -> List[pathlib.Path]:
    paths = []
    for sub in TARGET_ROOTS:
        base = root / sub
        if base.is_dir():
            paths.extend(base.rglob("*.py"))
    for name in TARGET_FILES:
        p = root / name
        if p.is_file():
            paths.append(p)
    for pattern in TEST_GLOBS:
        paths.extend(root.glob(pattern))
    return sorted(
        p for p in paths
        if not any(part in EXCLUDE_PARTS for part in p.parts)
    )


class ProjectModel:
    """All target files + the test and docs corpora, with cross-file
    lookups, built once. ``files`` paths under ``tests/`` go to
    :attr:`tests` (read by the contract rules, never linted); the rest
    are the lint targets in :attr:`files`."""

    def __init__(self, files: Dict[str, str],
                 docs: Optional[Dict[str, str]] = None,
                 root: Optional[pathlib.Path] = None):
        self.root = root
        parsed = {
            path: FileContext(path, src) for path, src in sorted(files.items())
        }
        self.files: Dict[str, FileContext] = {
            p: c for p, c in parsed.items() if not c.in_tests}
        self.tests: Dict[str, FileContext] = {
            p: c for p, c in parsed.items() if c.in_tests}
        self.docs: Dict[str, str] = dict(docs or {})
        self._predeclared: Optional[Set[str]] = None
        self._known_seams: Optional[Set[str]] = None
        self._tests_text: Optional[str] = None

    @classmethod
    def from_repo(cls, root) -> "ProjectModel":
        root = pathlib.Path(root)
        files = {
            str(p.relative_to(root)): p.read_text()
            for p in _iter_target_paths(root)
        }
        docs = {}
        doc_dir = root / "docs" / "source"
        if doc_dir.is_dir():
            docs = {
                str(p.relative_to(root)): p.read_text()
                for p in sorted(doc_dir.glob("*.rst"))
            }
        return cls(files, docs=docs, root=root)

    # -- module / import resolution -------------------------------------- #

    def module_file(self, module: str) -> Optional[FileContext]:
        """``trlx_tpu_torch.serve.slots`` -> its FileContext (or the package's
        ``__init__.py``), when the module is part of the lint surface."""
        rel = module.replace(".", "/")
        for candidate in (f"{rel}.py", f"{rel}/__init__.py"):
            if candidate in self.files:
                return self.files[candidate]
        return None

    def imported_from(self, ctx: FileContext,
                      name: str) -> Optional[Tuple[str, str]]:
        """Resolve a local name bound by a top-level import in ``ctx`` to
        ``(module, original_name)``; None when ``name`` is not
        import-bound."""
        if ctx.tree is None:
            return None
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if (alias.asname or alias.name) == name:
                        return (node.module, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if (alias.asname or alias.name.split(".")[0]) == name:
                        return (alias.name, "")
        return None

    def module_string_tuple(self, ctx: FileContext,
                            varname: str) -> Optional[List[str]]:
        """Module-level ``VAR = ("a", "b", ...)`` -> its strings."""
        if ctx.tree is None:
            return None
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == varname:
                    return _const_strings(node.value)
        return None

    # -- contract-sync corpora ------------------------------------------- #

    def predeclared_metrics(self) -> Set[str]:
        """Every metric name reachable from a ``predeclare(...)`` call:
        literal list/tuple arguments, module-level tuple constants passed
        by name, and tuple constants imported from another target module
        (``SLO_COUNTERS`` style)."""
        if self._predeclared is not None:
            return self._predeclared
        names: Set[str] = set()
        for ctx in self.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                fn = node.func
                called = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else ""
                )
                if called != "predeclare":
                    continue
                names.update(self._strings_behind(ctx, node.args[0]))
        self._predeclared = names
        return names

    def _strings_behind(self, ctx: FileContext, expr) -> List[str]:
        direct = _const_strings(expr)
        if direct:
            return direct
        if isinstance(expr, ast.Name):
            local = self.module_string_tuple(ctx, expr.id)
            if local is not None:
                return local
            origin = self.imported_from(ctx, expr.id)
            if origin is not None:
                module, orig = origin
                target = self.module_file(module)
                if target is not None and orig:
                    remote = self.module_string_tuple(target, orig)
                    if remote is not None:
                        return remote
        return []

    def known_seams(self) -> Set[str]:
        """The chaos-seam registry: ``KNOWN_SEAMS`` in supervisor/chaos.py
        (or whichever in-model module defines it)."""
        if self._known_seams is not None:
            return self._known_seams
        seams: Set[str] = set()
        for ctx in self.files.values():
            if not ctx.in_library:
                continue
            found = self.module_string_tuple(ctx, "KNOWN_SEAMS")
            if found:
                seams.update(found)
        self._known_seams = seams
        return seams

    def tests_text(self) -> str:
        if self._tests_text is None:
            self._tests_text = "\n".join(
                ctx.source for ctx in self.tests.values())
        return self._tests_text

    def observability_doc(self) -> str:
        return "\n".join(self.docs.get(doc, "") for doc in (
            OBSERVABILITY_DOC, PORT_OBSERVABILITY_DOC))


def _const_strings(expr) -> List[str]:
    """String constants in a literal tuple/list/set (or one string)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [expr.value]
    if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for el in expr.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append(el.value)
        return out
    return []
