"""CLI: ``python -m trlx_tpu_torch.analysis [root] [--select a,b] [...]``
(the port of ``python -m trlx_tpu.analysis``, with its flags and exit
codes, over ``trlx_tpu_torch/`` and ``chip_smoke.py``).

Exit status 0 = clean, 1 = findings (or a blown ``--budget``),
2 = usage error. Free of torch/numpy imports, so a run stays a fast
pure-AST pass.

Output modes: the default text format (one finding per line + fix
hint), ``--format json`` (one object: the findings with file, line,
rule, message and hint, and the file and rule counts), ``--format
sarif`` (SARIF 2.1.0 JSON on stdout, for CI PR annotation), and
``--threads`` (the computed whole-program thread model: root ->
reachable functions -> locks touched).

``--changed-only <git-ref>`` keeps the MODEL whole (cross-file rules —
chaos registry sync, kernel parity, thread contexts — stay sound) but
reports only findings in files changed vs the ref, for pre-commit use.
``--budget <seconds>`` makes the run fail when it exceeds its own
walltime budget.
"""

import argparse
import json
import subprocess
import sys
import time

from trlx_tpu_torch.analysis import RULES, _load_rules, run_lint

#: SARIF severity for graftlint findings: every rule is build-blocking
#: (exit 1), so every result is level "error"
_SARIF_LEVEL = "error"


def _sarif(findings, rules) -> dict:
    """SARIF 2.1.0: the minimal shape CI annotators consume — driver
    name + rule catalog, one result per finding with ruleId, level,
    message and a physicalLocation (uri + startLine)."""
    return {
        "version": "2.1.0",
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "trlx_tpu_torch/analysis/__init__.py",
                "rules": [
                    {
                        "id": r.id,
                        "shortDescription": {"text": r.rationale},
                        "help": {"text": r.hint},
                    }
                    for r in sorted(rules.values(), key=lambda r: r.id)
                ],
            }},
            "results": [
                {
                    "ruleId": f.rule,
                    "level": _SARIF_LEVEL,
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.file},
                            "region": {"startLine": f.line},
                        },
                    }],
                }
                for f in findings
            ],
        }],
    }


def _json(findings, project, rules) -> dict:
    """The findings as plain JSON: one object per finding (file, line,
    rule, message, hint) and the files and rules the run covered."""
    return {
        "findings": [
            {"file": f.file, "line": f.line, "rule": f.rule,
             "message": f.message, "hint": f.hint}
            for f in findings
        ],
        "files": len(project.files),
        "rules": len(rules),
    }


def _changed_files(root, ref: str):
    """Repo-relative paths changed vs ``ref`` plus untracked files, or
    None when git cannot answer (caller turns that into exit 2)."""
    cwd = root if root is not None else None
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref],
            capture_output=True, text=True, cwd=cwd,
        )
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, cwd=cwd,
        )
    except OSError:
        return None
    out = {p.strip() for p in diff.stdout.splitlines() if p.strip()}
    if untracked.returncode == 0:
        out.update(
            p.strip() for p in untracked.stdout.splitlines() if p.strip()
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.analysis",
        description="graftlint over trlx_tpu_torch — the port's AST "
                    "invariant checker",
    )
    ap.add_argument("root", nargs="?", default=None,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--select", default=None, metavar="RULE[,RULE]",
                    help="run only these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"), dest="fmt",
                    help="finding output format (default: text)")
    ap.add_argument("--threads", action="store_true",
                    help="print the computed thread model and exit")
    ap.add_argument("--changed-only", default=None, metavar="GIT_REF",
                    help="report findings only in files changed vs the "
                         "ref (model still built whole-repo)")
    ap.add_argument("--budget", type=float, default=None,
                    metavar="SECONDS",
                    help="fail (exit 1) when the run exceeds this "
                         "walltime")
    args = ap.parse_args(argv)
    started = time.monotonic()

    if args.list_rules:
        _load_rules()
        fam = ""
        for rule in sorted(RULES.values(),
                           key=lambda r: (r.family, r.id)):
            if rule.family != fam:
                fam = rule.family
                print(f"\n[{fam}]")
            print(f"  {rule.id:24s} {rule.rationale.split(';')[0]}")
        return 0

    changed = None
    if args.changed_only is not None:
        changed = _changed_files(args.root, args.changed_only)
        if changed is None:
            print(f"error: git diff --name-only {args.changed_only} "
                  f"failed (not a repo, or unknown ref)",
                  file=sys.stderr)
            return 2

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    try:
        findings, project = run_lint(root=args.root, select=select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.threads:
        from trlx_tpu_torch.analysis.concurrency import thread_model

        print(thread_model(project).report())
        return 0

    if changed is not None:
        findings = [f for f in findings if f.file in changed]

    if args.fmt == "sarif":
        json.dump(_sarif(findings, RULES), sys.stdout, indent=2)
        print()
        return 1 if findings else 0
    if args.fmt == "json":
        json.dump(_json(findings, project, RULES), sys.stdout, indent=2)
        print()
        return 1 if findings else 0

    for f in findings:
        print(f.render())
    nfiles = len(project.files)
    status = 0
    if findings:
        bad = len({f.file for f in findings})
        scope = f" (changed vs {args.changed_only})" if changed else ""
        print(f"\n{len(findings)} finding(s) in {bad} of {nfiles} "
              f"files{scope}")
        status = 1
    else:
        scope = ""
        if changed is not None:
            in_model = len({p for p in changed if p in project.files})
            scope = (f" ({in_model} changed vs {args.changed_only} "
                     f"reported)")
        print(f"clean: {nfiles} files, {len(RULES)} rules{scope}")
    if args.budget is not None:
        elapsed = time.monotonic() - started
        if elapsed > args.budget:
            print(f"budget exceeded: {elapsed:.1f}s > "
                  f"{args.budget:.1f}s — lint must stay fast enough "
                  f"to run on every commit", file=sys.stderr)
            status = max(status, 1)
    return status


if __name__ == "__main__":
    sys.exit(main())
