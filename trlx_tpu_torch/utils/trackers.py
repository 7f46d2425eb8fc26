"""Experiment trackers: wandb (optional) with a print fallback (port of
trlx_tpu.utils.trackers).

A tracker is a callable taking one flat stats dict per emission, the
same signature as the trainers' ``log_fn``, so a user's log function,
the print fallback, a JSONL file and wandb are interchangeable. Keys
ending in ``_table`` hold ``{"columns": [...], "rows": [[...], ...]}``
and go to table logging (wandb.Table) or compact text; the step is read
from the ``iter`` key when present. :func:`make_tracker` builds the one
``train.tracker`` names (``print``, ``none``, ``jsonl:<path>``,
``wandb``), wrapped in :class:`ResilientTracker` (retries, then stdout)
and silent off the main process. Without the ``wandb`` package (the
card's machine has none) ``wandb`` falls back to print with a notice.
"""

import importlib
import json
import os
from typing import Any, Dict, List, Optional


def _split(stats: Dict[str, Any]):
    """(scalars, tables): route `*_table` dict values to table logging."""
    scalars, tables = {}, {}
    for k, v in stats.items():
        if k.endswith("_table") and isinstance(v, dict) and "rows" in v:
            tables[k] = v
        else:
            scalars[k] = v
    return scalars, tables


class PrintTracker:
    """Default sink: one line per emission, tables as truncated text.

    Mirrors the reference's `accelerator.print` stdout path
    (accelerate_base_model.py:88)."""

    def __init__(self, max_table_rows: int = 4):
        self.max_table_rows = max_table_rows

    def __call__(self, stats: Dict[str, Any]) -> None:
        scalars, tables = _split(stats)
        printable = {
            k: (round(v, 5) if isinstance(v, float) else v)
            for k, v in scalars.items()
            if not isinstance(v, (list, tuple, dict))
        }
        print(printable, flush=True)
        for name, tbl in tables.items():
            cols = tbl.get("columns", [])
            print(f"-- {name} {cols}", flush=True)
            for row in tbl["rows"][: self.max_table_rows]:
                cells = [
                    (c if len(c) <= 64 else c[:61] + "...")
                    if isinstance(c, str)
                    else c
                    for c in row
                ]
                print(f"   {cells}", flush=True)

    def finish(self) -> None:
        pass


class WandbTracker:
    """wandb sink with the reference's init semantics: project from
    `TrainConfig.project_name`, full config dict attached
    (accelerate_base_model.py:58-61). Import is lazy and optional —
    construction raises ImportError if wandb is unavailable; callers use
    `make_tracker` to fall back to print."""

    def __init__(self, project_name: str, config_dict: Optional[Dict] = None,
                 **init_kwargs):
        self._wandb = importlib.import_module("wandb")
        self._last_step: Optional[int] = None
        self.run = self._wandb.init(
            project=project_name or None, config=config_dict, **init_kwargs
        )

    def __call__(self, stats: Dict[str, Any]) -> None:
        scalars, tables = _split(stats)
        step = scalars.get("iter")
        # emissions without an `iter` (eval tables, rollout-refresh info
        # logged between train iterations) reuse the last seen step:
        # wandb's step=None silently re-monotonizes and misaligns those
        # rows against the train series they belong with
        if step is None:
            step = self._last_step
        else:
            step = int(step)
            self._last_step = step
        payload = {
            k: v for k, v in scalars.items()
            if not isinstance(v, (list, tuple, dict))
        }
        for name, tbl in tables.items():
            payload[name] = self._wandb.Table(
                columns=list(tbl.get("columns", [])),
                rows=[list(r) for r in tbl["rows"]],
            )
        self._wandb.log(payload, step=step)

    def finish(self) -> None:
        self.run.finish()


class JsonlTracker:
    """Append-only JSONL sink for offline runs / tests.

    The parent directory is created lazily at the first emission — a
    ``jsonl:runs/x/log.jsonl`` spec whose directory doesn't exist yet must
    not fail every emission until ResilientTracker degrades it to stdout.
    ``finish()`` fsyncs, so a run killed right after its final emission
    doesn't lose the tail to the page cache."""

    def __init__(self, path: str):
        self.path = path
        self._dir_ready = False

    def __call__(self, stats: Dict[str, Any]) -> None:
        def default(o):
            try:
                return float(o)
            except (TypeError, ValueError):
                return str(o)

        if not self._dir_ready:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._dir_ready = True
        with open(self.path, "a") as f:
            f.write(json.dumps(stats, default=default) + "\n")

    def finish(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "a") as f:
            f.flush()
            os.fsync(f.fileno())


class ResilientTracker:
    """Fault isolation for metric sinks: an emission failure is retried
    (bounded, trlx_tpu_torch.utils.faults.retry_call), and a PERSISTENTLY
    failing sink — `max_consecutive_failures` emissions in a row lost
    despite retries — degrades to PrintTracker with a warning. Metrics
    are telemetry; losing their transport must never kill a training run
    (the reference's exception-swallowing went too far the other way and
    hid real bugs — here every failure is printed, the run just doesn't
    die)."""

    def __init__(self, inner, retries: int = 1, backoff: float = 0.5,
                 max_consecutive_failures: int = 3,
                 fallback_factory=PrintTracker, timeout: float = 0.0):
        self.inner = inner
        self.retries = retries
        self.backoff = backoff
        self.max_consecutive_failures = max_consecutive_failures
        self.fallback_factory = fallback_factory
        # > 0: each emission attempt runs through a bounded worker — a
        # sink that HANGS (wandb stuck in a TCP retry loop) times out,
        # counts as a lost emission, and degrades like any failure
        # (trlx_tpu_torch.supervisor.seams; train.host_call_timeout)
        self.timeout = timeout
        self.failures = 0
        self.degraded = False
        self._failed_inner = None  # the original sink, kept for finish()

    def __call__(self, stats: Dict[str, Any]) -> None:
        from trlx_tpu_torch import telemetry
        from trlx_tpu_torch.utils.faults import retry_call

        if self.degraded:
            self.inner(stats)
            return
        try:
            retry_call(self.inner, stats, retries=self.retries,
                       backoff=self.backoff, label="tracker emission",
                       timeout=self.timeout, seam="tracker")
            self.failures = 0
        except Exception as e:
            self.failures += 1
            telemetry.inc("fault/tracker_emissions_lost")
            print(f"[trlx_tpu_torch] tracker emission lost after retries "
                  f"({type(e).__name__}: {e}); "
                  f"{self.failures}/{self.max_consecutive_failures} "
                  f"consecutive failures", flush=True)
            if self.failures >= self.max_consecutive_failures:
                print("[trlx_tpu_torch] tracker persistently failing; degrading "
                      "to stdout for the rest of the run", flush=True)
                telemetry.inc("fault/tracker_degraded")
                self.degraded = True
                self._failed_inner = self.inner
                self.inner = self.fallback_factory()
                self.inner(stats)

    def finish(self) -> None:
        # on a degraded sink, ALSO try to finish the original failed
        # inner: a wandb run left open keeps its upload threads alive and
        # leaks the process on exit even though emissions moved to stdout
        for sink in (self.inner, self._failed_inner):
            if sink is None:
                continue
            try:
                sink.finish()
            except Exception as e:
                print(f"[trlx_tpu_torch] tracker finish failed ({e!r}); ignored",
                      flush=True)


class MultiTracker:
    def __init__(self, *trackers):
        self.trackers = [t for t in trackers if t is not None]

    def __call__(self, stats: Dict[str, Any]) -> None:
        for t in self.trackers:
            t(stats)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


def make_tracker(config=None, kind: Optional[str] = None):
    """Build the configured tracker, main-process aware.

    `kind` (or `config.train.tracker`): "wandb", "print", "none"/None, or a
    "jsonl:<path>" spec. "wandb" degrades to print with a notice when the
    package is missing or init fails (e.g. no network) — a missing tracker
    must never kill a training run — and a wandb/jsonl sink that starts
    failing MID-RUN is retried then degraded to stdout the same way
    (ResilientTracker; retry budget from train.host_retries). Non-main
    processes always get a no-op (parity: main-process-only tracker init,
    accelerate_base_model.py:58-61)."""
    from trlx_tpu_torch.utils import is_main_process

    if not is_main_process():
        return _NULL

    train = getattr(config, "train", None)
    kind = kind if kind is not None else getattr(train, "tracker", "print")

    def resilient(inner):
        from trlx_tpu_torch.supervisor import seam_timeout

        return ResilientTracker(
            inner,
            retries=getattr(train, "host_retries", 1),
            backoff=getattr(train, "host_retry_backoff", 0.5),
            timeout=seam_timeout(train),
        )

    if kind in (None, "none", ""):
        return _NULL
    if isinstance(kind, str) and kind.startswith("jsonl:"):
        return resilient(JsonlTracker(kind.split(":", 1)[1]))
    if kind == "wandb":
        project = getattr(train, "project_name", "")
        cfg_dict = config.to_dict() if hasattr(config, "to_dict") else None
        try:
            return resilient(WandbTracker(project, cfg_dict))
        except Exception as e:  # missing package, offline, auth failure
            print(f"[trlx_tpu_torch] wandb tracker unavailable ({e!r}); "
                  f"falling back to stdout", flush=True)
            return PrintTracker()
    return PrintTracker()


class _NullTracker:
    def __call__(self, stats: Dict[str, Any]) -> None:
        pass

    def finish(self) -> None:
        pass


_NULL = _NullTracker()


def generations_table(queries: List[str], responses: List[str],
                      scores) -> Dict[str, Any]:
    """The PPO eval table: decoded query / response / score rows
    (reference: accelerate_ppo_model.py:147-161)."""
    return {
        "columns": ["query", "response", "score"],
        "rows": [
            [q, r, float(s)] for q, r, s in zip(queries, responses, scores)
        ],
    }


def samples_table(samples: List[str], rewards=None,
                  max_rows: int = 128) -> Dict[str, Any]:
    """The ILQL eval table: sampled text (+ reward when scored), first 128
    rows (reference: accelerate_ilql_model.py:128-157)."""
    if rewards is None:
        rows = [[s] for s in samples[:max_rows]]
        return {"columns": ["sample"], "rows": rows}
    rows = [
        [s, float(r)] for s, r in zip(samples[:max_rows], rewards)
    ]
    return {"columns": ["sample", "reward"], "rows": rows}
