"""One run of one cell: find its files by name, check the card, set up,
measure for ``--seconds``, check the outputs against the plain reference,
and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything a cell is made of is found by name: ``workloads/<cell>.json``
names its ``config`` (``configs/<config>.json``), its ``traffic``
(``traffic/<traffic>.json``) and its ``driver`` (``drivers/<driver>.py``);
the configuration's ``spec`` names its architecture (``arch/<arch>.py``);
``BENCHMARK.json`` at the root of the checkout says which end-to-end
and per-layer metrics the cell reports, and each per-layer metric is read
by ``metrics/<metric>.py``. Adding any of these adds files and edits
none.
"""

import argparse
import contextlib
import functools
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that may not be loaded by a run (the JAX side)
FORBIDDEN = ("jax", "jaxlib", "flax", "trlx_tpu")


def load_json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots),
    loaded once per file."""
    module = name.replace(".", "_").replace("-", "_")
    return _load(os.path.join(HERE, kind, f"{name}.py"),
                 f"perfbench.{kind}.{module}")


@functools.cache
def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def arch(spec: Dict):
    """The module of a configuration's architecture, ``arch/<arch>.py``
    by its ``spec``'s ``arch``: checkpoint layout, reference math, names,
    the program's leaves and the FLOP count."""
    return load_module("arch", spec["arch"])


def benchmark(path: Optional[str] = None) -> Dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(bench: Dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: a
    metric with ``workloads`` in those cells, one without in every cell
    (a per-layer one without: every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell's files, the run's arguments, the
    spans it records around its calls into the program, and the
    tracer."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: Optional[Dict] = None):
        from perfbench.tracing import Tracer

        self.name = cell
        self.cell = load_json("workloads", f"{cell}.json")
        for key, value in (overrides or {}).items():
            self.cell[key] = value
        self.config = load_json("configs", f"{self.cell['config']}.json")
        if "spec" in (overrides or {}):
            self.config = dict(self.config, spec=overrides["spec"])
        self.traffic = load_json("traffic", f"{self.cell['traffic']}.json")
        if "traffic_params" in (overrides or {}):
            self.traffic = overrides["traffic_params"]
        self.seed, self.seconds, self.device = int(seed), seconds, device
        self.tracer = Tracer(trace)
        self.spans: List[tuple] = []

    @property
    def spec(self) -> Dict:
        return self.config["spec"]

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A benchmark span around a call into the program (host clock;
        ``sync``: closed after the device finished the call's work)."""
        t0 = time.perf_counter()
        with self.tracer.label(name):
            yield
            if sync:
                self.sync()
        self.spans.append((name, t0, time.perf_counter()))

    def span_times(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.spans if n == name]


def card() -> Dict:
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        power = float(limit[0]) if limit else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        power = None
    return {"name": name, "power_limit_w": power}


def release_memory(device: str) -> None:
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()


def allocated_gib() -> float:
    import torch

    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated() / 2**30


class Readings:
    """What a per-layer metric's reader reads."""

    def __init__(self, ctx: Context, data: Dict, timeline, peaks):
        self.ctx, self.data, self.timeline, self.peaks = \
            ctx, data, timeline, peaks


def run(argv=None, require_card: bool = True,
        overrides: Optional[Dict] = None, bench_path: Optional[str] = None,
        t_start: Optional[float] = None, out=None, patch=None) -> int:
    """One run; prints the result line on ``out`` (stdout) and returns the
    exit code. Tests pass ``require_card=False`` with tiny ``overrides``
    to drive a run on the CPU, ``patch(driver)`` to break its timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = benchmark(bench_path)
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace),
                  device="cuda" if require_card else "cpu",
                  overrides=overrides)
    chips = int(ctx.cell["chips"])
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {chips} CUDA device(s); "
                  f"found {found}", file=sys.stderr)
            return 3
        device = dict(card(), count=chips)
    else:
        device = {"name": "cpu", "power_limit_w": None, "count": chips}

    driver = load_module("drivers", ctx.cell["driver"]).make(ctx)
    if patch is not None:
        patch(driver)
    driver.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    if require_card:
        for d in range(chips):
            torch.cuda.reset_peak_memory_stats(d)
    ctx.spans.clear()  # the window's spans only
    result = driver.window()
    ctx.sync()
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(chips)),
               default=0) if require_card else 0
    e2e, layer = metrics_of(bench, ctx.name)
    values = dict(result["metrics"], setup_s=setup_s)
    driver.release()
    release_memory(ctx.device)
    print(f"perfbench: {allocated_gib():.2f} GiB held after the program "
          f"was released", file=sys.stderr)
    checks = driver.check()
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)

    metrics = {}
    record = {"correct": correct, "attempted": int(result["attempted"]),
              "failed": int(result["failed"])}
    dev = {"platform": "gpu" if require_card else "cpu",
           "kind": device["name"], "count": chips,
           "memory_peak_bytes": int(peak),
           "power_limit_w": device["power_limit_w"]}
    if args.trace:
        from perfbench import yardstick

        timeline = ctx.tracer.timeline
        readings = Readings(ctx, result.get("readings", {}), timeline,
                            yardstick.peaks(device["name"]))
        for m in layer:
            value = load_module("metrics", m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if timeline is not None:
            dev["busy_s"] = timeline.busy_s
            dev["window_s"] = timeline.window_s
            record["breakdown"] = timeline.breakdown()
    else:
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    record["metrics"] = metrics
    record["device"] = dev
    record["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r}) "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record), file=out, flush=True)
    return 0
