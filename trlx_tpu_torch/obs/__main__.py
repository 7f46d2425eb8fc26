"""``python -m trlx_tpu_torch.obs`` — the fleet observability CLI (the port
of ``python -m trlx_tpu.obs``).

Three subcommands over the router's sampled ``access.jsonl`` (see
trlx_tpu_torch.router.obs; docs "Observability"):

- ``summarize <log>`` — per-backend p50/p95 TTFT/ITL, hedge win rate,
  failover/breaker counts (``--json`` for the raw dict);
- ``trace <id> --log <log>`` — print one stitched request's event
  timeline; ``--perfetto [-o OUT]`` exports it as a Chrome-trace JSON
  file Perfetto opens directly, next to the trainer's ``trace.jsonl``;
- ``tail <log>`` — follow the log with SLO-breach/error highlighting
  (``--no-follow`` prints the last ``-n`` lines and exits — the mode
  the smoke test drives).

Stdlib-only, like everything on the router path.
"""

import argparse
import json
import os
import sys
import time

from trlx_tpu_torch.obs import (
    find_record,
    format_line,
    format_summary,
    perfetto_events,
    read_records,
    summarize,
)


def _cmd_summarize(args) -> int:
    records = read_records(args.log)
    report = summarize(records)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_summary(report))
    return 0


def _cmd_trace(args) -> int:
    record = find_record(read_records(args.log), args.trace_id)
    if record is None:
        print(f"no stitched trace '{args.trace_id}' in {args.log} "
              f"(sampled log — tail captures always land; try the "
              f"router's GET /debug/trace/{args.trace_id})",
              file=sys.stderr)
        return 1
    if args.perfetto:
        out = args.out or os.path.join(
            os.path.dirname(os.path.abspath(args.log)),
            f"trace_{args.trace_id}.json",
        )
        with open(out, "w") as f:
            json.dump({"traceEvents": perfetto_events(record)}, f)
        print(f"wrote {out} (open in https://ui.perfetto.dev)")
        return 0
    print(format_line(record, color=not args.no_color))
    for event in record.get("events", ()):
        extras = {k: v for k, v in event.items()
                  if k not in ("t_ms", "event")}
        print(f"  {event.get('t_ms', 0.0):>9.3f}ms "
              f"{event.get('event', '?'):<22} "
              + " ".join(f"{k}={v}" for k, v in extras.items()))
    replica = record.get("replica")
    if isinstance(replica, dict):
        print("  replica: " + " ".join(
            f"{k}={v}" for k, v in sorted(replica.items())
        ))
    return 0


def _cmd_tail(args) -> int:
    color = not args.no_color and (sys.stdout.isatty() or args.color)
    try:
        with open(args.log) as f:
            lines = f.readlines()
            for line in lines[-args.lines:]:
                _print_line(line, color)
            if args.no_follow:
                return 0
            while True:
                line = f.readline()
                if line:
                    _print_line(line, color)
                else:
                    time.sleep(0.25)
    except KeyboardInterrupt:
        return 0


def _print_line(line: str, color: bool) -> None:
    line = line.strip()
    if not line:
        return
    try:
        record = json.loads(line)
    except json.JSONDecodeError:
        return
    if isinstance(record, dict):
        print(format_line(record, color=color), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.obs",
        description="read side of the fleet observability plane: "
                    "summarize / trace / tail over the router's "
                    "access.jsonl",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("summarize",
                       help="per-backend latency/hedge/failover report")
    p.add_argument("log", help="path to access.jsonl")
    p.add_argument("--json", action="store_true",
                   help="emit the raw report dict")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("trace", help="one stitched request's timeline")
    p.add_argument("trace_id")
    p.add_argument("--log", required=True, help="path to access.jsonl")
    p.add_argument("--perfetto", action="store_true",
                   help="export Chrome-trace JSON instead of printing")
    p.add_argument("-o", "--out", default="",
                   help="perfetto output path (default "
                        "trace_<id>.json next to the log)")
    p.add_argument("--no-color", action="store_true")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("tail", help="follow the access log")
    p.add_argument("log", help="path to access.jsonl")
    p.add_argument("-n", "--lines", type=int, default=20,
                   help="backlog lines to print first (default 20)")
    p.add_argument("--no-follow", action="store_true",
                   help="print the backlog and exit")
    p.add_argument("--color", action="store_true",
                   help="force color even when stdout is not a tty")
    p.add_argument("--no-color", action="store_true")
    p.set_defaults(fn=_cmd_tail)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
