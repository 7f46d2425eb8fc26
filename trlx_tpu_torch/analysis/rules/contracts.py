"""Contract-sync rules: telemetry catalog, chaos-seam and kernel
coverage (port of trlx_tpu.analysis.rules.contracts).

The observability stack works on a closed-world assumption: every
counter is predeclared (so a Prometheus scrape sees an explicit zero,
not a gap that breaks rate()), and every ``serve/*`` / ``fault/*`` name
is in the docs/source/observability.rst catalog operators alert on (the
port keeps trlx_tpu's metric names, so one catalog serves both).
Likewise every chaos seam named at a call site must be in
``KNOWN_SEAMS`` (trlx_tpu_torch/supervisor/chaos.py) and exercised by at
least one of the port's tests — a seam nobody injects is a fault path
that has never run — and every kernel module under
``trlx_tpu_torch/ops/`` must be imported by one.
"""

import ast
import re
from typing import Iterable, List, Optional, Tuple

from trlx_tpu_torch.analysis import Rule, register
from trlx_tpu_torch.analysis.model import LIB, FileContext, _const_strings

#: counter namespaces under the predeclaration contract
_COUNTER_PREFIXES = ("serve/", "fault/", "checkpoint/", "chaos/",
                     "telemetry/", "compile/", "router/", "slo/")

#: namespaces the observability.rst catalog must cover
_DOC_PREFIXES = ("serve/", "fault/", "router/", "checkpoint/", "slo/")

_EMITTERS = ("inc", "set_gauge", "observe")


def _callee_leaf(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _literal_metric(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) and (
        isinstance(node.args[0].value, str)
    ):
        return node.args[0].value
    return None


def _emitted_metrics(ctx: FileContext,
                     kinds: Tuple[str, ...]) -> Iterable[Tuple[str, int]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _callee_leaf(node) not in kinds:
            continue
        name = _literal_metric(node)
        if name is not None:
            yield name, node.lineno


class LibraryRule(Rule):
    """Base: fan out over parsed library files."""

    def run(self, project) -> Iterable:
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            yield from self.check(ctx, project)

    def check(self, ctx: FileContext, project) -> Iterable:
        raise NotImplementedError


@register
class MetricPredeclaredRule(LibraryRule):
    id = "metric-predeclared"
    family = "contracts"
    rationale = (
        "a counter that first exists when it first fires is invisible "
        "to every scrape before that: rate() sees a gap, dashboards "
        "show 'no data' instead of 0, and alerts on the absence never "
        "arm — predeclaration (telemetry.predeclare) is the fix, and "
        "this rule keeps every inc() site inside it"
    )
    hint = (
        "add the name to the predeclared tuple its subsystem registers "
        "(_PREDECLARED_COUNTERS, _SERVE_COUNTERS, SLO_COUNTERS) or "
        "pass it through telemetry.predeclare() at startup"
    )

    def check(self, ctx, project):
        declared = project.predeclared_metrics()
        for name, line in _emitted_metrics(ctx, ("inc",)):
            if not name.startswith(_COUNTER_PREFIXES):
                continue
            if name not in declared:
                yield self.finding(
                    ctx, line,
                    f"counter '{name}' is incremented but never "
                    f"predeclared — scrapes before the first event "
                    f"see a gap, not a zero",
                )


@register
class MetricDocumentedRule(LibraryRule):
    id = "metric-documented"
    family = "contracts"
    rationale = (
        "docs/source/observability.rst (with the port's own page, "
        "torch_observability.rst) is the catalog operators build "
        "dashboards and alerts from; a serve/* or fault/* name emitted "
        "but not catalogued is telemetry nobody will ever look at, and "
        "the doc silently rots into a partial list"
    )
    hint = (
        "add the metric (name, type, meaning) to the matching table "
        "in docs/source/observability.rst, or for a name only the port "
        "emits, in docs/source/torch_observability.rst"
    )

    def check(self, ctx, project):
        doc = project.observability_doc()
        for name, line in _emitted_metrics(ctx, _EMITTERS):
            if not name.startswith(_DOC_PREFIXES):
                continue
            if name not in doc:
                yield self.finding(
                    ctx, line,
                    f"metric '{name}' is emitted but missing from the "
                    f"observability.rst catalog",
                )


@register
class MetricDynamicNameRule(LibraryRule):
    id = "metric-dynamic-name"
    family = "contracts"
    rationale = (
        "an f-string metric name in the serve/ or fault/ namespace "
        "defeats both contracts above — the checker (and the catalog) "
        "cannot enumerate names minted at runtime, and unbounded label "
        "cardinality is the classic way a metrics backend falls over"
    )
    hint = (
        "use a fixed metric name; put the varying part in the value "
        "or a bounded enum of predeclared names"
    )

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_leaf(node) not in _EMITTERS:
                continue
            if not node.args or not isinstance(node.args[0], ast.JoinedStr):
                continue
            head = node.args[0].values[0] if node.args[0].values else None
            if (
                isinstance(head, ast.Constant)
                and isinstance(head.value, str)
                and head.value.startswith(_DOC_PREFIXES)
            ):
                yield self.finding(
                    ctx, node.lineno,
                    f"dynamic metric name f\"{head.value}...\" — names "
                    f"in serve//fault/ must be static literals",
                )


@register
class MetricNameLiteralRule(LibraryRule):
    id = "metric-name-literal"
    family = "contracts"
    rationale = (
        "with labels in the registry, the varying part of a metric "
        "belongs in the label dict, never in the name: a name built at "
        "the call site (f-string, concatenation, %-format, .format()) "
        "is invisible to the predeclaration and catalog contracts even "
        "when it never varies, and one loop variable away from "
        "unbounded series cardinality — every inc/set_gauge/observe "
        "outside trlx_tpu_torch/telemetry/ must pass its name as a literal "
        "(or a variable bound to one)"
    )
    hint = (
        "pass a string literal and move the varying part into "
        "labels={...}, e.g. observe('serve/request_latency', dt, "
        "labels={'path': path})"
    )

    #: the registry's own plumbing legitimately forwards computed
    #: names (tracer time/<phase> spans, device gauges)
    _EXEMPT = LIB + "telemetry/"

    def check(self, ctx, project):
        if ctx.path.startswith(self._EXEMPT):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callee_leaf(node) not in _EMITTERS:
                continue
            if not node.args:
                continue
            how = self._constructed(node.args[0])
            if how is None:
                continue
            yield self.finding(
                ctx, node.lineno,
                f"metric name built with {how} at the emit site — pass "
                f"a literal name and put the varying part in labels=",
            )

    @staticmethod
    def _constructed(arg: ast.expr) -> Optional[str]:
        if isinstance(arg, ast.JoinedStr):
            return "an f-string"
        if isinstance(arg, ast.BinOp):
            return "+ / % string construction"
        if isinstance(arg, ast.Call) and _callee_leaf(arg) == "format":
            return "a .format() call"
        return None


#: outbound-HTTP constructors/calls that accept (and must be passed) an
#: explicit timeout keyword — urllib.request.urlopen and the http.client
#: connection classes both default to socket._GLOBAL_DEFAULT_TIMEOUT,
#: i.e. block forever
_HTTP_CALLEES = ("urlopen", "HTTPConnection", "HTTPSConnection")


@register
class HttpTimeoutRequiredRule(LibraryRule):
    id = "http-timeout-required"
    family = "contracts"
    rationale = (
        "the fleet router is an HTTP *client* inside the serving path: "
        "urllib/http.client default to no socket timeout, so one hung "
        "backend turns a missing timeout= into a silently wedged router "
        "thread — a fleet-wide stall with no exception, no watchdog "
        "attribution, and no retry; every outbound call under "
        "trlx_tpu_torch/ "
        "must bound its wait explicitly"
    )
    hint = (
        "pass timeout=<seconds> explicitly (wire it to a config knob "
        "like router.probe_timeout / router.request_timeout, not a "
        "magic number)"
    )

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = _callee_leaf(node)
            if leaf not in _HTTP_CALLEES:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            yield self.finding(
                ctx, node.lineno,
                f"outbound HTTP call '{leaf}(...)' without an explicit "
                f"timeout= — defaults to blocking forever on a hung "
                f"peer",
            )


def _literal_seams(ctx: FileContext) -> Iterable[Tuple[str, int]]:
    """Seam names at injection points: maybe_inject("x"), phase("x"),
    and any seam="x" keyword (retry_call and friends)."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        leaf = _callee_leaf(node)
        if leaf in ("maybe_inject", "phase"):
            name = _literal_metric(node)
            if name is not None:
                yield name, node.lineno
        for kw in node.keywords:
            if kw.arg == "seam" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                yield kw.value.value, node.lineno


@register
class ChaosSeamRegisteredRule(LibraryRule):
    id = "chaos-seam-registered"
    family = "contracts"
    rationale = (
        "chaos schedules are parsed against seam names as free-form "
        "strings; a call site naming a seam absent from KNOWN_SEAMS "
        "(supervisor/chaos.py) can never be targeted by a drill and a "
        "typo there fails silently — the registry makes the seam "
        "namespace closed and checkable"
    )
    hint = (
        "add the seam to KNOWN_SEAMS in trlx_tpu_torch/supervisor/chaos.py "
        "(and give it a chaos drill test)"
    )

    def check(self, ctx, project):
        if ctx.path == LIB + "supervisor/chaos.py":
            return
        known = project.known_seams()
        for seam, line in _literal_seams(ctx):
            if seam not in known:
                yield self.finding(
                    ctx, line,
                    f"chaos seam '{seam}' is not registered in "
                    f"KNOWN_SEAMS (supervisor/chaos.py)",
                )


@register
class ChaosSeamTestedRule(Rule):
    id = "chaos-seam-tested"
    family = "contracts"
    rationale = (
        "a registered seam no test ever injects is a fault-handling "
        "path that has never executed — the 'shipped dead' "
        "checkpointing failure the reference survey documents "
        "(SURVEY §3.6), which this repo's chaos drills exist to "
        "prevent; every seam must appear in at least one test"
    )
    hint = (
        "add a chaos drill (chaos.configure('<seam>:...')) exercising "
        "the seam, or remove it from KNOWN_SEAMS"
    )

    def run(self, project):
        corpus = project.tests_text()
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.in_library:
                continue
            seams = self._registry(ctx)
            if seams is None:
                continue
            line, names = seams
            for seam in names:
                if seam not in corpus:
                    yield self.finding(
                        ctx, line,
                        f"registered chaos seam '{seam}' is never "
                        f"exercised by any test",
                    )

    def _registry(self,
                  ctx: FileContext) -> Optional[Tuple[int, List[str]]]:
        for node in ctx.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "KNOWN_SEAMS":
                    return node.lineno, _const_strings(node.value)
        return None


#: the serving doc whose error-taxonomy table every typed HTTP error
#: must appear in (docs/source/serving.rst, "Error taxonomy")
SERVING_DOC = "docs/source/serving.rst"

#: a doc line counts as a taxonomy row only when it also names an HTTP
#: 4xx/5xx status — prose that merely mentions the class doesn't
_STATUS_RE = re.compile(r"\b[45]\d\d\b")


@register
class ErrorTaxonomyDocumentedRule(LibraryRule):
    id = "error-taxonomy-documented"
    family = "contracts"
    rationale = (
        "the serving HTTP surface maps typed exceptions to status codes "
        "(429 quota/queue, 503 replay/deadline/fleet, 508 hop loop); "
        "clients and the fleet router branch on those codes, so an "
        "exception class added under trlx_tpu_torch/serve/ or "
        "trlx_tpu_torch/router/ "
        "without a row in the serving.rst error table is a wire contract "
        "nobody documented — operators cannot tell a shed from a fault, "
        "and the next handler author guesses the status"
    )
    hint = (
        "add the class to the error-taxonomy table in "
        "docs/source/serving.rst: one row naming the class AND its HTTP "
        "status code (e.g. 'QuotaExceeded ... 429')"
    )

    #: the HTTP-facing subsystems under the contract
    _SCOPE = (LIB + "serve/", LIB + "router/")

    def check(self, ctx, project):
        if not ctx.path.startswith(self._SCOPE):
            return
        doc_rows = [
            line for line in project.docs.get(SERVING_DOC, "").splitlines()
            if _STATUS_RE.search(line)
        ]
        for name, line in self._exception_classes(ctx):
            if name.startswith("_"):
                continue  # internal plumbing, not a wire contract
            if not any(name in row for row in doc_rows):
                yield self.finding(
                    ctx, line,
                    f"typed HTTP error '{name}' has no row in the "
                    f"serving.rst error-taxonomy table (class name + "
                    f"status code on one line)",
                )

    @staticmethod
    def _exception_classes(ctx: FileContext) -> List[Tuple[str, int]]:
        """(name, line) of every class that IS-A exception: a base name
        ending Error/Exception, or — to a fixpoint — a base that is
        itself such a class in this file (Draining(QueueFull) and
        QuotaExceeded(QueueFull) are taxonomy members too)."""
        classes = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            bases = []
            for b in node.bases:
                if isinstance(b, ast.Name):
                    bases.append(b.id)
                elif isinstance(b, ast.Attribute):
                    bases.append(b.attr)
            classes[node.name] = (bases, node.lineno)
        excs = set()
        changed = True
        while changed:
            changed = False
            for name, (bases, _) in classes.items():
                if name in excs:
                    continue
                if any(b.endswith(("Error", "Exception")) or b in excs
                       for b in bases):
                    excs.add(name)
                    changed = True
        return sorted(
            ((name, classes[name][1]) for name in excs),
            key=lambda pair: pair[1],
        )


#: calls that make an ops module a kernel module: a port wrapper counts
#: each launch of its hand-written kernel (``ops.count_launch``);
#: ``pallas_call`` never appears in the port, and is kept so that this
#: rule and trlx_tpu's agree on the same source
_KERNEL_CALLS = ("count_launch", "pallas_call")


@register
class KernelParityTestedRule(Rule):
    id = "kernel-parity-tested"
    family = "contracts"
    rationale = (
        "a CUDA kernel that no test imports only ever runs on the card — "
        "its plain version, the CPU path its wrapper takes on a CPU "
        "tensor, is never held against trlx_tpu by tier-1, so a drifted "
        "online-softmax or dequant step ships silently; the CPU parity "
        "tests and the card checks are the kernel's only oracles"
    )
    hint = (
        "add a tests/test_torch_*.py file that imports the module and "
        "holds it against trlx_tpu (see tests/test_torch_paged_attention"
        ".py), or drop the kernel from the module"
    )

    def run(self, project):
        for ctx in project.files.values():
            if ctx.tree is None or not ctx.path.startswith(LIB + "ops/"):
                continue
            line = self._kernel_call_line(ctx)
            if line is None:
                continue
            module = ctx.path[:-len(".py")].replace("/", ".")
            if not self._imported_by_tests(project, module):
                yield self.finding(
                    ctx, line,
                    f"kernel module '{module}' launches a kernel but is "
                    f"not imported by any of the port's tests",
                )

    @staticmethod
    def _kernel_call_line(ctx: FileContext) -> Optional[int]:
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and _callee_leaf(node) in _KERNEL_CALLS):
                return node.lineno
        return None

    @staticmethod
    def _imported_by_tests(project, module: str) -> bool:
        parent, _, stem = module.rpartition(".")
        for ctx in project.tests.values():
            if ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Import):
                    if any(a.name == module for a in node.names):
                        return True
                elif isinstance(node, ast.ImportFrom):
                    if node.module == module:
                        return True
                    if (node.module == parent
                            and any(a.name == stem for a in node.names)):
                        return True
        return False
