#!/usr/bin/env python3
"""Find a serving cell's knee: the highest arrival rate at which the
window's TTFT and ITL tails stay within the cell's ``slo`` and the
backlog does not grow. One process builds the engine once, then runs the
cell's open loop at each rate in turn (warm-up, a window of
``--seconds``, then a drain), and prints one JSON line per rate and the
knee, stopping at the first rate past it (rates ascending). The cell's
``rate`` is then set by hand to 0.8 of the knee.

    python3 perfbench/sweep_rate.py --workload serve-gptj6b-sessions
        --seed 12345 --seconds 20 --rates 4,8,12,16

A backlog grows when the window's last third of requests waits for its
first token more than twice as long, at the median, as its first third.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--grace", type=float, default=15.0,
                    help="seconds past the close a request is waited for")
    args = ap.parse_args(argv)

    from perfbench import harness

    ctx = harness.Context(args.workload, args.seed, args.seconds, False)
    slo = ctx.cell["slo"]
    rates = [float(r) for r in args.rates.split(",")]
    ctx.cell["rate"] = rates[0]
    driver = harness.load_module("drivers", ctx.cell["driver"]).make(ctx)
    driver.grace = args.grace
    driver.setup()
    knee = None
    for i, rate in enumerate(rates):
        if i:
            ctx.cell["rate"] = rate
            driver.start_load()
        out = driver.window()
        ttft = [driver.sent[j][1].times[0] - driver.origin
                - driver.requests[j][0] for j in driver.done]
        third = max(1, len(ttft) // 3)
        growing = bool(ttft) and bool(
            np.median(ttft[-third:]) > 2 * np.median(ttft[:third]))
        m = out["metrics"]
        ok = (not out["failed"] and not growing
              and m["ttft_p95_ms"] <= slo["ttft_p95_ms"]
              and m.get("itl_p95_ms", 0.0) <= slo["itl_p95_ms"])
        knee = rate if ok else knee
        print(json.dumps({"rate": rate, "attempted": out["attempted"],
                          "failed": out["failed"], "growing": growing,
                          "within_slo": ok, **m,
                          "step_ms": out["readings"]["step_ms"],
                          "sender_late_ms": driver.late_ms}), flush=True)
        if not ok:  # the rates run in ascending order: past the knee
            break
        driver.drain()
    print(json.dumps({"knee": knee, "cell_rate": None if knee is None
                      else round(0.8 * knee, 3), "slo": slo}), flush=True)
    driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
