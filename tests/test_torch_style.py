"""Tier-1 bridge into the port's graftlint (``trlx_tpu_torch.analysis``):
one ``test_torch_lint[<relpath>]`` id per file of ``trlx_tpu_torch/``
and for ``chip_smoke.py``, failing with the rendered findings for that
file. The port's tests are its test corpus, not its targets: ``tests/``
is linted by trlx_tpu's engine (tests/test_style.py), so no file carries
two lint ids.

The rules themselves — the shared fixtures through both engines, the
torch-hazard fixtures, suppressions and the CLI — are tested in
tests/test_torch_graftlint.py."""

import pathlib

import pytest

from trlx_tpu_torch.analysis import run_lint
from trlx_tpu_torch.analysis.model import ProjectModel

REPO = pathlib.Path(__file__).resolve().parent.parent

# One parse + one rule pass for the whole port at collection time (the
# cross-file rules need every file anyway), then findings fan out to
# per-file test ids.
_MODEL = ProjectModel.from_repo(REPO)
TARGETS = sorted(_MODEL.files)
_FINDINGS, _ = run_lint(project=_MODEL)
_BY_FILE = {}
for _f in _FINDINGS:
    _BY_FILE.setdefault(_f.file, []).append(_f)


@pytest.mark.parametrize("path", TARGETS)
def test_torch_lint(path):
    findings = _BY_FILE.get(path, [])
    assert not findings, "\n" + "\n".join(f.render() for f in findings)


def test_torch_lint_covers_the_whole_port():
    """The target set is every module of the port plus chip_smoke.py,
    the port's tests are the test corpus (never targets), and no finding
    points outside the checked set."""
    on_disk = sorted(
        str(p.relative_to(REPO))
        for p in (REPO / "trlx_tpu_torch").rglob("*.py")
        if "__pycache__" not in p.parts)
    assert TARGETS == sorted(on_disk + ["chip_smoke.py"])
    assert "trlx_tpu_torch/analysis/rules/torch_hazards.py" in TARGETS
    corpus = set(_MODEL.tests)
    assert "tests/test_torch_style.py" in corpus
    assert "tests/torch_serve_mesh_worker.py" in corpus
    assert all(p.startswith(("tests/test_torch_", "tests/torch_"))
               for p in corpus)
    assert not corpus & set(TARGETS)
    assert "docs/source/observability.rst" in _MODEL.docs
    assert set(_BY_FILE) <= set(TARGETS)


def test_torch_lint_waivers_carry_a_justification():
    """Every ``# lint: disable=`` in the port says why (an unjustified
    one is itself a finding, ``bad-suppression``) and silences a rule
    that really fired there."""
    waivers = [(path, sup) for path, ctx in _MODEL.files.items()
               for sup in ctx.suppressions]
    assert waivers, "the port carries at least the serve-clock waiver"
    for path, sup in waivers:
        assert sup.justification, f"{path}:{sup.line}"
        assert sup.used, f"{path}:{sup.line} waives nothing"
