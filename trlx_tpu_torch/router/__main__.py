"""``python -m trlx_tpu_torch.router`` — backend list in, fleet endpoint
out (the port of ``python -m trlx_tpu.router``, flag for flag).

The minimal launch is just ``--backends host:port,host:port``; the
``router:`` section of a training config (``--config``, YAML or JSON)
supplies the rest, and the flags below win over both. Host code only:
the router runs on a CPU-only front-end box in front of
``python -m trlx_tpu_torch.serve`` replicas on their cards. See
docs/source/serving.rst ("Fleet routing").
"""

import argparse
import json
import sys

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.router import FleetRouter, RouterConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.router",
        description="Front a fleet of trlx_tpu_torch.serve replicas with "
                    "prefix-affinity routing and rolling upgrades.",
    )
    p.add_argument("--backends", default=None,
                   help="comma-separated replica endpoints, e.g. "
                        "'10.0.0.1:8081,10.0.0.2:8081' (required here "
                        "or in the YAML router: section)")
    p.add_argument("--config", default=None,
                   help="training config, YAML (needs pyyaml) or JSON, "
                        "whose router: section supplies defaults for the "
                        "flags below")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--page-size", type=int, default=None,
                   help="affinity-block granularity in tokens — match "
                        "the backends' serve.page_size")
    p.add_argument("--probe-interval", type=float, default=None,
                   help="health-prober sweep period (seconds)")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="per-forward HTTP timeout toward a backend")
    p.add_argument("--failover-retries", type=int, default=None,
                   help="extra replicas tried after an idempotent-safe "
                        "failure (connection error, 429, 503)")
    p.add_argument("--rollout-timeout", type=float, default=None,
                   help="per-replica budget for one rolling-upgrade "
                        "step (drain + reload + readiness probe)")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="TTFT objective for router/fleet_goodput "
                        "(0 = every completed request counts good)")
    p.add_argument("--stall-timeout", type=float, default=None,
                   help="watchdog budget per prober sweep (0 = off)")
    p.add_argument("--probe-failures-threshold", type=int, default=None,
                   help="consecutive failed prober sweeps before a "
                        "replica is ejected (debounce)")
    p.add_argument("--breaker-threshold", type=int, default=None,
                   help="consecutive request failures that open a "
                        "backend's circuit breaker (0 = breakers off)")
    p.add_argument("--breaker-cooldown", type=float, default=None,
                   help="seconds an open breaker waits before one "
                        "half-open trial request")
    p.add_argument("--retry-budget", type=float, default=None,
                   help="fleet-wide failover/hedge token-bucket "
                        "capacity (0 = unlimited)")
    p.add_argument("--retry-budget-refill", type=float, default=None,
                   help="retry-budget refill rate (tokens per second)")
    p.add_argument("--hedge-after", type=float, default=None,
                   dest="hedge_after_s",
                   help="hedging floor in seconds: 0 disables; > 0 "
                        "fires a backup request on a second replica "
                        "after max(floor, rolling p95)")
    p.add_argument("--trace-ring", type=int, default=None,
                   help="stitched-trace ring capacity behind "
                        "GET /debug/trace/<id> (0 = off)")
    p.add_argument("--access-log", default=None,
                   help="path for the sampled access.jsonl of stitched "
                        "fleet traces (empty = off); read it back with "
                        "python -m trlx_tpu_torch.obs")
    p.add_argument("--access-log-sample", type=int, default=None,
                   help="write every Nth request to the access log "
                        "(tail captures — SLO breach, error, hedge, "
                        "failover — always land)")
    p.add_argument("--access-log-max-mb", type=float, default=None,
                   help="rotate access.jsonl to .1 past this size")
    p.add_argument("--slo-target", type=float, default=None,
                   help="goodput objective for the slo/burn_rate_* "
                        "gauges, e.g. 0.99")
    p.add_argument("--tenants", default=None,
                   help="inline JSON per-tenant retry-budget slices, "
                        "e.g. '{\"premium\": {\"rps\": 2, \"burst\": 4, "
                        "\"priority\": 10}}' (usually from the YAML "
                        "router: section instead)")
    p.add_argument("--shed-pressure-threshold", type=float, default=None,
                   help="shed best-effort tenants locally when this "
                        "fraction of admitting replicas publish "
                        "pressure (<= 0 disables, 1.0 = whole fleet)")
    return p


def router_config_from_args(args) -> RouterConfig:
    """The router: config section (when --config names a file carrying
    one) with CLI flags layered on top."""
    section = {}
    if args.config:
        with open(args.config) as f:
            if args.config.endswith(".json"):
                loaded = json.load(f)
            else:
                import yaml  # only YAML configs need pyyaml

                loaded = yaml.safe_load(f)
        section = (loaded or {}).get("router") or {}
    if args.backends is not None:
        section["backends"] = [
            b.strip() for b in args.backends.split(",") if b.strip()
        ]
    if args.tenants is not None:
        section["tenants"] = json.loads(args.tenants)
    cfg = RouterConfig.from_dict(section)
    for flag in ("host", "port", "page_size", "probe_interval",
                 "request_timeout", "failover_retries", "rollout_timeout",
                 "slo_ttft_ms", "stall_timeout",
                 "probe_failures_threshold", "breaker_threshold",
                 "breaker_cooldown", "retry_budget",
                 "retry_budget_refill", "hedge_after_s",
                 "trace_ring", "access_log", "access_log_sample",
                 "access_log_max_mb", "slo_target",
                 "shed_pressure_threshold"):
        value = getattr(args, flag)
        if value is not None:
            setattr(cfg, flag, value)
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = router_config_from_args(args)
    telemetry.start()
    router = FleetRouter(config).start()
    router.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
