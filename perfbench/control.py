#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, at the
cell's own size, several seeds in one process:

- ``program``: the program's numbers against the float32 reference
  (the lower reading: the largest over a dozen seeds or more);
- ``control``: the reference computed one precision below the
  configuration's (float8 for its bf16) in the program's place (the
  upper reading: the smallest over the seeds);
- ``half``: the reference with half of each batch left out, the mean
  taken over the rest, in the program's place (a fault a limit has to
  catch).

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13
        [--only program] [--seconds S]

Each seed runs a window of ``--seconds`` (training cells read their
numbers in set-up; the window is kept so that the program is released as
a run releases it). One JSON line per seed and reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="program,control,half")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from perfbench import harness
    from perfbench.reference import gpt

    kinds = args.only.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(args.workload, seed, args.seconds, False)
        driver = harness.load_module("drivers", ctx.cell["driver"]).make(ctx)
        t0 = time.perf_counter()
        driver.setup()
        driver.window()
        driver.release()
        harness.release_memory(ctx.device)
        print(f"seed {seed}: {harness.allocated_gib():.2f} GiB held after "
              f"the program was released", file=sys.stderr, flush=True)
        ref = driver.reference(gpt.Precision("float32"))
        rows = {}
        if "program" in kinds:
            rows["program"] = driver.gaps(driver.recorded, ref)
        if "control" in kinds:
            rows["control"] = driver.gaps(
                driver.reference(gpt.Precision("float8")), ref)
        if "half" in kinds and hasattr(driver, "half_fault"):
            rows["half"] = driver.gaps(driver.half_fault(), ref)
        for kind, gaps in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": kind, "gaps": gaps,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        del driver, ref
        harness.release_memory(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
