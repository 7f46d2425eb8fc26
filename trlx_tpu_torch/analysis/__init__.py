"""graftlint over the port: the AST invariant checker of trlx_tpu
(trlx_tpu.analysis), with its rules retargeted at ``trlx_tpu_torch/``
and ``chip_smoke.py``.

The port runs on the invariants trlx_tpu's linter guards there: one
serve clock (``supervisor.monotonic``), every counter predeclared so
scrapes see zeros not gaps, no ad-hoc timing, scheduler and allocator
state touched only under its lock, every chaos seam registered and
tested, every kernel module held against trlx_tpu by a test — plus the
CUDA-graph hazards of its own ``aot_jit`` (no host sync inside a
captured function, no wrapper built in a loop).

Architecture, as trlx_tpu's:

- :mod:`trlx_tpu_torch.analysis.model` — parsed files + the light
  cross-file project model (import resolution, module constants, the
  port's test corpus and the docs).
- :mod:`trlx_tpu_torch.analysis.rules` — the rule families (style,
  locks, concurrency, contracts, torch). Importing the subpackage
  registers every rule in THIS package's :data:`RULES`, a registry of
  its own: a process that imports both linters (a pytest worker) never
  mixes the two rule sets.
- this module — the engine: build the model, run the rules, apply
  ``# lint: disable=<rule> -- <justification>`` suppressions (a missing
  justification is itself a finding), sort and return.

Entry points: ``python -m trlx_tpu_torch.analysis`` (CLI),
``tests/test_torch_style.py`` (the tier-1 pytest bridge, one test id
per file), and ``tests/test_torch_graftlint.py`` (both engines on the
shared fixtures, the torch rules on their own). The package imports
neither jax nor trlx_tpu: it is pure ``ast``.
"""

import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

from trlx_tpu_torch.analysis.model import (  # noqa: F401  (re-exports)
    FileContext,
    ProjectModel,
)


class Finding:
    """One rule violation: ``file:line``, the rule id, the message, and
    the fix hint the CLI prints underneath."""

    __slots__ = ("file", "line", "rule", "message", "hint")

    def __init__(self, file: str, line: int, rule: str, message: str,
                 hint: str = ""):
        self.file = file
        self.line = line
        self.rule = rule
        self.message = message
        self.hint = hint

    def __repr__(self):
        return f"Finding({self.file}:{self.line} [{self.rule}])"

    def render(self) -> str:
        out = f"{self.file}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class Rule:
    """One invariant. Subclasses set the metadata and implement
    ``run(project)``; ``@register`` puts an instance in :data:`RULES`.

    ``rationale`` is the incident/invariant the rule protects — it is
    what ``--list-rules`` and the SARIF catalog print, so a rule cannot
    land without saying why it exists."""

    id: str = ""
    family: str = ""
    rationale: str = ""
    hint: str = ""

    def run(self, project: ProjectModel) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx_or_path, line: int, message: str,
                hint: Optional[str] = None) -> Finding:
        path = getattr(ctx_or_path, "path", ctx_or_path)
        return Finding(path, line, self.id, message,
                       self.hint if hint is None else hint)


#: rule id -> rule instance; populated by @register at import
RULES: Dict[str, Rule] = {}

#: suppressions may never silence these (a suppression problem must not
#: be able to suppress itself; a file that fails to parse can carry no
#: trustworthy suppression comments)
UNSUPPRESSABLE = ("bad-suppression", "syntax-error")


def register(cls):
    rule = cls()
    if not rule.id or not rule.family or not rule.rationale:
        raise ValueError(f"rule {cls.__name__} needs id/family/rationale")
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id '{rule.id}'")
    RULES[rule.id] = rule
    return cls


def _load_rules() -> None:
    import trlx_tpu_torch.analysis.rules  # noqa: F401  (registers on import)


def run_rules(project: ProjectModel,
              select: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run (selected) rules over the model and apply suppressions."""
    _load_rules()
    wanted = set(select) if select else None
    # bad-suppression is emitted by the engine itself, not a registered
    # rule, but it is selectable like any other id
    unknown = (wanted or set()) - set(RULES) - {"bad-suppression"}
    if unknown:
        raise ValueError(
            f"unknown rule id(s): {', '.join(sorted(unknown))} "
            f"(see --list-rules)"
        )
    findings: List[Finding] = []
    for rule_id, rule in sorted(RULES.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        findings.extend(rule.run(project))
    findings = _apply_suppressions(project, findings)
    if wanted is None or "bad-suppression" in wanted:
        findings.extend(_bad_suppressions(project))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def _apply_suppressions(project: ProjectModel,
                        findings: List[Finding]) -> List[Finding]:
    kept = []
    for f in findings:
        ctx = project.files.get(f.file)
        if ctx is None or f.rule in UNSUPPRESSABLE:
            kept.append(f)
            continue
        hit = None
        for sup in ctx.suppressions:
            if sup.justification and sup.covers(f.line, f.rule):
                hit = sup
                break
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    return kept


def _bad_suppressions(project: ProjectModel) -> List[Finding]:
    out = []
    for ctx in project.files.values():
        for sup in ctx.suppressions:
            if not sup.justification:
                out.append(Finding(
                    ctx.path, sup.line, "bad-suppression",
                    f"suppression of {', '.join(sorted(sup.rules))} has "
                    f"no justification",
                    "write '# lint: disable=<rule> -- <why this is "
                    "safe>'; the justification is the point — a waiver "
                    "nobody can audit is a dead invariant",
                ))
    return out


def run_lint(root=None, select: Optional[Iterable[str]] = None,
             project: Optional[ProjectModel] = None,
             ) -> Tuple[List[Finding], ProjectModel]:
    """Lint the repo at ``root`` (default: the tree this package sits
    in); returns (findings, the model) so callers can group/report."""
    if project is None:
        if root is None:
            root = pathlib.Path(__file__).resolve().parent.parent.parent
        project = ProjectModel.from_repo(root)
    return run_rules(project, select=select), project
