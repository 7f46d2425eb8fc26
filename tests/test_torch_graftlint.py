"""The port's graftlint (``trlx_tpu_torch.analysis``) against trlx_tpu's
(``trlx_tpu.analysis``), on the CPU:

- every fixture of tests/lint_fixtures/{style,locks,concurrency,
  contracts,suppression} (the ones tests/test_graftlint.py reads, none
  of them JAX) goes through both engines — mounted as a library module,
  and at every path-scoped mount test_graftlint.py uses, with its docs —
  under paths (and package imports) renamed ``trlx_tpu/`` ->
  ``trlx_tpu_torch/``: both give the same ``(rule, line)`` findings over
  the rules the two share, the same bad-suppression and unsuppressable
  handling. A ``tests/...`` file is the port's test corpus, never its
  target, so trlx_tpu's findings there are left out of the comparison;
- the torch family (``host-sync-in-jit``, ``jit-in-loop``) fires on its
  planted-bad fixtures in tests/lint_fixtures/torch/ and stays quiet on
  the clean ones; ``kernel-parity-tested`` sees the port's kernel
  wrappers (``ops.count_launch``);
- the two registries stay apart, and the CLI's exit codes and its
  ``--format json`` / ``sarif`` output are what trlx_tpu's CLI gives.
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest

from trlx_tpu.analysis import RULES as JAX_RULES
from trlx_tpu.analysis import run_rules as jax_run_rules
from trlx_tpu.analysis.model import ProjectModel as JaxProjectModel
from trlx_tpu_torch.analysis import RULES, run_lint, run_rules
from trlx_tpu_torch.analysis.model import OBSERVABILITY_DOC, ProjectModel

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
SHARED_DIRS = ("style", "locks", "concurrency", "contracts", "suppression")
SHARED_FAMILIES = ("style", "locks", "concurrency", "contracts")

#: trlx_tpu's synthetic mounts (tests/test_graftlint.py)
LIB = "trlx_tpu/mod.py"
REGISTRY = "trlx_tpu/supervisor/chaos.py"
KERNEL = "trlx_tpu/ops/fixture_kernel.py"
SERVING_DOC = "docs/source/serving.rst"
CATALOG = {OBSERVABILITY_DOC: (
    ".. list-table::\n"
    "   * - ``serve/fixture_latency``\n"
    "   * - ``fault/fixture_trip``\n")}
TAXONOMY = {SERVING_DOC: (
    "``FixtureQueueSaturated``  429  admission door saturated\n"
    "``FixtureShedding``        429  typed shed\n")}
PROSE = {SERVING_DOC: (
    "FixtureQueueSaturated is raised when the queue saturates.\n"
    "FixtureShedding marks a shed request.\n")}


def fixture(rel: str) -> str:
    return (FIXTURES / rel).read_text()


def _load_both():
    jax_run_rules(JaxProjectModel(files={}))
    run_rules(ProjectModel(files={}))


_load_both()
#: the rule ids both engines run: every rule of the four shared
#: families, and the engine's own bad-suppression
SHARED = sorted(
    {i for i, r in JAX_RULES.items() if r.family in SHARED_FAMILIES}
    | {"bad-suppression"})


def port_path(path: str) -> str:
    return re.sub(r"^trlx_tpu/", "trlx_tpu_torch/", path)


def port_source(src: str) -> str:
    return re.sub(r"\btrlx_tpu\b", "trlx_tpu_torch", src)


def both(files, docs=None, select=None):
    """(trlx_tpu's findings, the port's), each as sorted (rule, line,
    port path) triples; trlx_tpu's findings in tests/ files are dropped
    (the port's engine reads tests/ as its corpus, never lints it)."""
    select = SHARED if select is None else select
    jax = jax_run_rules(JaxProjectModel(files=files, docs=docs),
                        select=select)
    port = run_rules(ProjectModel(
        files={port_path(p): port_source(s) for p, s in files.items()},
        docs=docs), select=select)
    want = sorted((f.rule, f.line, port_path(f.file)) for f in jax
                  if not f.file.startswith("tests/"))
    got = sorted((f.rule, f.line, f.file) for f in port)
    return want, got


# --------------------------------------------------------------------- #
# both engines on every shared fixture
# --------------------------------------------------------------------- #

ALL_FIXTURES = sorted(
    str(p.relative_to(FIXTURES)) for d in SHARED_DIRS
    for p in (FIXTURES / d).glob("*.py"))


@pytest.mark.parametrize("rel", ALL_FIXTURES)
def test_both_engines_agree_on_each_fixture_as_a_library_module(rel):
    want, got = both({LIB: fixture(rel)})
    assert got == want


#: test_graftlint.py's path-scoped and multi-file mounts, with its docs
MOUNTS = {
    "serve_clock_bad@serve": ({"trlx_tpu/serve/mod.py":
                               "style/serve_clock_bad.py"}, None),
    "serve_clock_ok@serve": ({"trlx_tpu/serve/mod.py":
                              "style/serve_clock_ok.py"}, None),
    "serve_clock_bad@core": ({"trlx_tpu/core.py":
                              "style/serve_clock_bad.py"}, None),
    "library_only@tests": ({"tests/test_mod.py":
                            "style/bare_except_bad.py"}, None),
    "adhoc_timing@telemetry": ({"trlx_tpu/telemetry/mod.py":
                                "style/adhoc_timing_bad.py"}, None),
    "adhoc_timing@supervisor": ({"trlx_tpu/supervisor/mod.py":
                                 "style/adhoc_timing_bad.py"}, None),
    "adhoc_timing@analysis": ({"trlx_tpu/analysis/mod.py":
                               "style/adhoc_timing_bad.py"}, None),
    "adhoc_timing@utils": ({"trlx_tpu/utils/__init__.py":
                            "style/adhoc_timing_bad.py"}, None),
    "metric_name_literal@telemetry": ({"trlx_tpu/telemetry/mod.py":
                                       "contracts/metric_name_literal_bad.py"},
                                      None),
    "metric_documented+catalog": ({LIB: "contracts/metric_documented.py"},
                                  CATALOG),
    "error_taxonomy_bad@serve": ({"trlx_tpu/serve/mod.py":
                                  "contracts/error_taxonomy_bad.py"}, None),
    "error_taxonomy_ok@router+doc": ({"trlx_tpu/router/mod.py":
                                      "contracts/error_taxonomy_ok.py"},
                                     TAXONOMY),
    "error_taxonomy_ok@serve+prose": ({"trlx_tpu/serve/mod.py":
                                       "contracts/error_taxonomy_ok.py"},
                                      PROSE),
    "error_taxonomy_bad@utils": ({"trlx_tpu/utils/mod.py":
                                  "contracts/error_taxonomy_bad.py"}, None),
    "chaos_seam_registered_bad+registry": (
        {REGISTRY: "contracts/chaos_registry.py",
         "trlx_tpu/serve/mod.py": "contracts/chaos_seam_registered_bad.py"},
        None),
    "chaos_seam_registered_ok+registry": (
        {REGISTRY: "contracts/chaos_registry.py",
         "trlx_tpu/serve/mod.py": "contracts/chaos_seam_registered_ok.py"},
        None),
    "chaos_seam_tested@registry": ({REGISTRY: "contracts/chaos_registry.py"},
                                   None),
    "chaos_seam_tested+drill": (
        {REGISTRY: "contracts/chaos_registry.py",
         "tests/test_fixture_drill.py": "contracts/chaos_drill.py"}, None),
    "kernel_parity_bad@ops": ({KERNEL: "contracts/kernel_parity_tested_bad.py"},
                              None),
    "kernel_parity_bad@ops+test": (
        {KERNEL: "contracts/kernel_parity_tested_bad.py",
         "tests/test_fixture_kernel.py": "contracts/kernel_parity_drill.py"},
        None),
    "kernel_parity_ok@ops": ({KERNEL: "contracts/kernel_parity_tested_ok.py"},
                             None),
    "kernel_parity_bad@serve": ({"trlx_tpu/serve/mod.py":
                                 "contracts/kernel_parity_tested_bad.py"},
                                None),
}

#: rules each mount must fire, and rules it must not (so the agreement
#: is not vacuous, and the path scopes are the port's)
MOUNT_FIRES = {
    "serve_clock_bad@serve": ({"serve-clock"}, set()),
    "serve_clock_bad@core": (set(), {"serve-clock"}),
    "library_only@tests": (set(), {"bare-except"}),
    "adhoc_timing@telemetry": (set(), {"adhoc-timing"}),
    "adhoc_timing@utils": (set(), {"adhoc-timing"}),
    "metric_name_literal@telemetry": (set(), {"metric-name-literal"}),
    "metric_documented+catalog": (set(), {"metric-documented"}),
    "error_taxonomy_bad@serve": ({"error-taxonomy-documented"}, set()),
    "error_taxonomy_ok@router+doc": (set(), {"error-taxonomy-documented"}),
    "error_taxonomy_ok@serve+prose": ({"error-taxonomy-documented"}, set()),
    "chaos_seam_registered_bad+registry": ({"chaos-seam-registered"},
                                           set()),
    "chaos_seam_tested@registry": ({"chaos-seam-tested"}, set()),
    "chaos_seam_tested+drill": (set(), {"chaos-seam-tested"}),
    "kernel_parity_bad@ops": ({"kernel-parity-tested"}, set()),
    "kernel_parity_bad@ops+test": (set(), {"kernel-parity-tested"}),
}


@pytest.mark.parametrize("name", sorted(MOUNTS))
def test_both_engines_agree_at_each_scoped_mount(name):
    mounts, docs = MOUNTS[name]
    want, got = both({p: fixture(rel) for p, rel in mounts.items()},
                     docs=docs)
    assert got == want
    fires, quiet = MOUNT_FIRES.get(name, (set(), set()))
    rules = {rule for rule, _, _ in got}
    assert fires <= rules and not quiet & rules, got


def test_both_engines_agree_on_suppressions():
    """A justified waiver silences; an unjustified one silences nothing
    and is reported; bad-suppression cannot waive itself; a syntax error
    cannot be waived."""
    cases = [
        {LIB: fixture("suppression/suppressed_ok.py")},
        {LIB: fixture("suppression/suppressed_bad.py")},
        {LIB: "x = 1  # lint: disable=bad-suppression\n"},
        {LIB: "# lint: disable=syntax-error -- not parsed anyway\n"
              "def broken(:\n"},
    ]
    for files in cases:
        want, got = both(files, select=["none-comparison", "bad-suppression",
                                        "syntax-error"])
        assert got == want
    _, got = both(cases[1], select=["none-comparison", "bad-suppression"])
    assert [r for r, _, _ in got] == ["bad-suppression", "none-comparison"]
    _, got = both(cases[3], select=["syntax-error"])
    assert [r for r, _, _ in got] == ["syntax-error"]


# --------------------------------------------------------------------- #
# the port's rules on their own
# --------------------------------------------------------------------- #

PORT_LIB = "trlx_tpu_torch/mod.py"

#: (rule, fixture stem, mount): one planted-bad / clean pair per rule
SIMPLE = [
    ("host-sync-in-jit", "torch/host_sync", PORT_LIB),
    ("jit-in-loop", "torch/jit_in_loop", PORT_LIB),
    ("serve-clock", "style/serve_clock", "trlx_tpu_torch/serve/mod.py"),
    ("adhoc-timing", "style/adhoc_timing", PORT_LIB),
    ("guarded-by", "locks/guarded_by", PORT_LIB),
    ("race-detected", "concurrency/race_helper", PORT_LIB),
    ("lock-order-cycle", "concurrency/lock_order_3cycle", PORT_LIB),
]


def lint(files, select, docs=None):
    return run_rules(ProjectModel(files=files, docs=docs), select=select)


@pytest.mark.parametrize("rule,stem,path", SIMPLE,
                         ids=[case[0] for case in SIMPLE])
def test_port_rule_fires_on_planted_bad(rule, stem, path):
    findings = lint({path: port_source(fixture(f"{stem}_bad.py"))},
                    select=[rule])
    assert findings, f"{rule} did not fire on {stem}_bad.py"
    assert all(f.rule == rule and f.file == path and f.line > 0
               for f in findings)
    assert findings[0].hint
    assert f"{path}:{findings[0].line}" in findings[0].render()


@pytest.mark.parametrize("rule,stem,path", SIMPLE,
                         ids=[case[0] for case in SIMPLE])
def test_port_rule_quiet_on_clean(rule, stem, path):
    findings = lint({path: port_source(fixture(f"{stem}_ok.py"))},
                    select=[rule])
    assert findings == [], [f.render() for f in findings]


def test_host_sync_in_jit_finds_each_sync():
    """Each read-back in the bad fixture, in the module function passed
    to aot_jit inside a method and in a decorated one: float() on a
    tensor, .item(), torch.cuda.synchronize(), .tolist(), .cpu() and
    .numpy()."""
    findings = lint({PORT_LIB: fixture("torch/host_sync_bad.py")},
                    select=["host-sync-in-jit"])
    assert [f.line for f in findings] == [7, 8, 9, 10, 20, 20]
    text = " ".join(f.message for f in findings)
    for what in ("float()", ".item()", "synchronize()", ".tolist()",
                 ".cpu()", ".numpy()"):
        assert what in text, what


def test_torch_rules_are_library_only():
    for rel in ("torch/host_sync_bad.py", "torch/jit_in_loop_bad.py"):
        assert lint({"chip_smoke.py": fixture(rel)},
                    select=["host-sync-in-jit", "jit-in-loop"]) == []


def test_kernel_parity_tested_sees_the_port_wrappers():
    """A port kernel module counts its launches (``ops.count_launch``):
    under trlx_tpu_torch/ops/ it needs a test of the port that imports
    it; elsewhere, or imported, it is fine."""
    kernel = "trlx_tpu_torch/ops/fixture_kernel.py"
    src = fixture("torch/kernel_module.py")
    findings = lint({kernel: src}, select=["kernel-parity-tested"])
    assert [f.line for f in findings] == [9]
    assert "trlx_tpu_torch.ops.fixture_kernel" in findings[0].message
    drill = "from trlx_tpu_torch.ops import fixture_kernel\n"
    assert lint({kernel: src, "tests/test_torch_fixture.py": drill},
                select=["kernel-parity-tested"]) == []
    assert lint({"trlx_tpu_torch/serve/mod.py": src},
                select=["kernel-parity-tested"]) == []


def test_registries_stay_apart():
    """Each engine registers in its own RULES: the shared ids are two
    instances, the torch family exists only in the port's, the jax
    family only in trlx_tpu's, and use-after-donate has no counterpart
    (the port's aot_jit donates nothing)."""
    assert RULES is not JAX_RULES
    assert {r.family for r in RULES.values()} == {
        "style", "locks", "concurrency", "contracts", "torch"}
    assert RULES["host-sync-in-jit"].family == "torch"
    assert JAX_RULES["host-sync-in-jit"].family == "jax"
    assert "use-after-donate" in JAX_RULES
    assert "use-after-donate" not in RULES
    assert set(RULES) == (set(JAX_RULES) - {"use-after-donate"})
    for rule_id in SHARED:
        if rule_id in RULES:
            assert RULES[rule_id] is not JAX_RULES[rule_id]
    for rule in RULES.values():
        assert rule.id and rule.family and rule.rationale and rule.hint


def test_real_port_thread_inventory_is_modeled():
    from trlx_tpu_torch.analysis.concurrency import thread_model

    _, proj = run_lint(root=REPO, select=["race-detected"])
    tm = thread_model(proj)
    expected = {
        "trlx-torch-serve-slots", "trlx-torch-serve-batcher",
        "trlx-torch-serve-drain", "trlx-torch-serve-watch",
        "trlx-router-probe", "trlx-watchdog", "signal:SIGTERM",
        "http:_Handler.do_POST",
    }
    assert expected <= set(tm.roots), sorted(tm.roots)
    report = tm.report()
    for label in expected:
        assert f"[{label}]" in report


# --------------------------------------------------------------------- #
# the CLI: trlx_tpu's flags and exit codes, plus --format json
# --------------------------------------------------------------------- #

def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "trlx_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=120)


def _tmp_repo(root, bad=True):
    lib = root / "trlx_tpu_torch"
    lib.mkdir(parents=True)
    stem = "none_comparison_bad" if bad else "none_comparison_ok"
    (lib / "mod.py").write_text(fixture(f"style/{stem}.py"))
    (lib / "step.py").write_text(fixture(
        "torch/host_sync_bad.py" if bad else "torch/host_sync_ok.py"))
    return root


def test_cli_exit_codes_and_json(tmp_path):
    root = _tmp_repo(tmp_path / "bad", bad=True)
    text = _cli(str(root))
    assert text.returncode == 1
    assert "none-comparison" in text.stdout
    assert "host-sync-in-jit" in text.stdout
    out = _cli(str(root), "--format", "json")
    assert out.returncode == 1
    doc = json.loads(out.stdout)
    assert doc["files"] == 2 and doc["rules"] == len(RULES)
    rules = {(f["file"], f["rule"]) for f in doc["findings"]}
    assert ("trlx_tpu_torch/mod.py", "none-comparison") in rules
    assert ("trlx_tpu_torch/step.py", "host-sync-in-jit") in rules
    assert all(f["line"] > 0 and f["message"] and f["hint"]
               for f in doc["findings"])
    only = json.loads(_cli(str(root), "--format", "json", "--select",
                           "jit-in-loop").stdout)
    assert only["findings"] == []

    clean = _tmp_repo(tmp_path / "clean", bad=False)
    good = _cli(str(clean))
    assert good.returncode == 0, good.stdout + good.stderr
    assert "clean: 2 files" in good.stdout
    assert json.loads(_cli(str(clean), "--format", "json").stdout)[
        "findings"] == []
    sarif = _cli(str(clean), "--format", "sarif")
    assert sarif.returncode == 0
    run = json.loads(sarif.stdout)["runs"][0]
    assert run["results"] == []
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} == set(RULES)


def test_cli_usage_errors_list_rules_and_budget(tmp_path):
    root = _tmp_repo(tmp_path, bad=False)
    unknown = _cli(str(root), "--select", "no-such-rule")
    assert unknown.returncode == 2 and "no-such-rule" in unknown.stderr
    bad_ref = _cli(str(root), "--changed-only", "no-such-ref")
    assert bad_ref.returncode == 2 and "no-such-ref" in bad_ref.stderr
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert "[torch]" in listed.stdout and "host-sync-in-jit" in listed.stdout
    assert "use-after-donate" not in listed.stdout
    slow = _cli(str(root), "--budget", "0.000001")
    assert slow.returncode == 1 and "budget exceeded" in slow.stderr
    threads = _cli(str(root), "--threads")
    assert threads.returncode == 0


def test_cli_is_clean_on_the_port():
    """``python -m trlx_tpu_torch.analysis`` on this checkout: exit 0."""
    out = _cli()
    assert out.returncode == 0, out.stdout[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith("clean: ")
