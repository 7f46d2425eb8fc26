"""The port stands alone: importing every ``trlx_tpu_torch`` module (its
graftlint, ``trlx_tpu_torch.analysis``, too), and ``chip_smoke.py``, in a
fresh interpreter leaves ``jax``, every
``trlx_tpu`` module and ``transformers`` out of ``sys.modules``
(``trlx_tpu_torch`` itself shares that prefix, so the check compares
package names, not string prefixes), starts no thread and builds no
kernel and no host library."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys, threading
import trlx_tpu_torch
names = ["trlx_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(trlx_tpu_torch.__path__,
                                          "trlx_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from trlx_tpu_torch import native
from trlx_tpu_torch.ops import _build
print(json.dumps({
    "imported": names,
    "modules": sorted(sys.modules),
    "threads": threading.active_count(),
    "built": sorted(_build.BUILD_INFO) + sorted(native.BUILD_INFO),
}))
"""


def test_port_imports_no_jax_and_no_trlx_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "trlx_tpu_torch.serve.slots" in report["imported"]
    assert "trlx_tpu_torch.ops.paged_attention" in report["imported"]
    for name in ("ops.flash_attention", "ops.losses", "models.policy",
                 "trainers.ppo_trainer", "orchestrator.ppo_orchestrator",
                 "pipeline.ppo_pipeline", "examples.ppo_sentiments",
                 "data.ilql_types", "models.ilql", "trainers.ilql_trainer",
                 "orchestrator.offline_orchestrator",
                 "pipeline.offline_pipeline", "examples.ilql_randomwalks",
                 "examples.ilql_sentiments", "examples.randomwalks_data",
                 "utils.checkpoint", "utils.preemption", "utils.faults",
                 "utils.trackers", "models.reward", "examples.ppo_tldr",
                 "utils.aotjit", "utils.profiling", "telemetry",
                 "telemetry.registry", "telemetry.tracer",
                 "telemetry.device", "telemetry.flops",
                 "telemetry.prometheus", "supervisor", "supervisor.seams",
                 "supervisor.chaos", "models.hf_import", "utils.hf_offline",
                 "parallel", "parallel.mesh", "parallel.runtime",
                 "parallel.sharding", "parallel.exchange",
                 "ops.ring_attention", "ops.pipeline_parallel",
                 "serve.layouts", "serve.follower", "router",
                 "router.resilience", "router.obs", "router.__main__", "obs",
                 "obs.__main__", "native", "analysis", "analysis.model",
                 "analysis.concurrency", "analysis.__main__",
                 "analysis.rules", "analysis.rules.style",
                 "analysis.rules.locks", "analysis.rules.concurrency",
                 "analysis.rules.contracts",
                 "analysis.rules.torch_hazards"):
        assert f"trlx_tpu_torch.{name}" in report["imported"]
    leaked = [
        m for m in report["modules"]
        if m.split(".")[0] in ("jax", "jaxlib", "trlx_tpu", "flax", "optax")
    ]
    assert leaked == []
    # transformers only inside load_trunk_from_hf (the card's machine has
    # none)
    assert "transformers" not in {m.split(".")[0] for m in report["modules"]}
    assert report["threads"] == 1
    assert report["built"] == []
