"""``python -m trlx_tpu_torch.serve`` — a checkpoint (or a config and
weights) in, an HTTP endpoint out.

``--checkpoint`` takes a checkpoint directory of the port's PPO trainer
or a run directory of ``step_<N>`` checkpoints (the newest committed one
is used); the config then comes from the checkpoint's meta.json, and
``--config`` overrides it. Without ``--checkpoint`` the config file is
required, and the weights are a ``torch.save`` file of the port's decode
views (``--weights``, see trlx_tpu_torch.models.params) or, without it,
a random policy made from ``--seed``. A config file is a trlx_tpu
training config (YAML, or the same three-section layout as JSON); its
``serve:`` section sizes the bucket lattice and the slot pool, and the
flags below win over it. The server runs on the card unless ``--device
cpu``.

Examples::

    python -m trlx_tpu_torch.serve --checkpoint ckpts --port 8080
    python -m trlx_tpu_torch.serve --config configs/test_config.yml \\
        --buckets 4x16x16,8x16x16 --slots 8 --page-size 8 \\
        --attention pallas --kv-dtype int8 --weights-dtype int8 --port 8080
    python -m trlx_tpu_torch.serve --checkpoint ckpts --speculation lookup \\
        --spec-k 4
    python -m trlx_tpu_torch.serve --checkpoint ckpts --scheduler static
    python -m trlx_tpu_torch.serve --checkpoint ckpts --stall-timeout 60 \
        --watch-checkpoints 30 --drain-timeout 30

    torchrun --nproc_per_node 2 -m trlx_tpu_torch.serve \
        --config configs/test_config.yml --mesh tp=2 --port 8080
    torchrun --nproc_per_node 2 -m trlx_tpu_torch.serve \
        --config configs/test_config.yml --mesh tp=2 --scheduler static \
        --buckets 4x16x16,8x16x16

The serve watchdog is armed by ``serve.stall_timeout`` (the flag, or
the config's ``serve:`` section, as ``configs/ppo_config.yml`` sets
it); SIGTERM drains and exits 0. ``--mesh tp=N[,fsdp=M]`` serves one
model over the tp x fsdp processes of a ``torchrun`` launch (one card
each; with ``--device cpu`` gloo processes): process 0 answers HTTP and
the others follow its device calls under either scheduler
(trlx_tpu_torch.serve.follower), each arming the watchdog and exiting 0
after the drain.
"""

import argparse
import json
import sys

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.params import load_decode_views
from trlx_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from trlx_tpu_torch.serve.server import InferenceServer


def parse_buckets(spec: str):
    """"8x32x16,16x64x32" -> [[8, 32, 16], [16, 64, 32]] (BxPxG)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        dims = part.lower().split("x")
        if len(dims) != 3:
            raise ValueError(
                f"bucket '{part}' is not BATCHxPROMPTxGEN (e.g. 8x32x16)"
            )
        out.append([int(d) for d in dims])
    return out


def parse_mesh(spec: str):
    """"tp=2,fsdp=2" -> {"tp": 2, "fsdp": 2} ("" -> single-device)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"mesh axis '{part}' is not AXIS=SIZE (e.g. tp=2,fsdp=2)"
            )
        axis, _, size = part.partition("=")
        out[axis.strip()] = int(size)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.serve",
        description="Serve a policy over HTTP with the PyTorch/CUDA port.",
    )
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir, or a run dir of step_<N> dirs "
                        "(the newest committed one is used)")
    p.add_argument("--config", default=None,
                   help="training config, YAML (needs pyyaml) or JSON; "
                        "default with --checkpoint: the config in the "
                        "checkpoint's meta.json")
    p.add_argument("--weights", default=None,
                   help="torch.save file of decode views; default: a "
                        "random policy made from --seed")
    p.add_argument("--seed", type=int, default=None,
                   help="random-init and sampling seed (serve.seed)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: cuda (raises without a card)")
    p.add_argument("--buckets", default=None,
                   help="comma-separated BATCHxPROMPTxGEN lattice, e.g. "
                        "'8x16x48,16x16x48' (overrides the serve: section)")
    p.add_argument("--max-wait-ms", type=float, default=None,
                   help="the static micro-batcher's coalescing deadline")
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission-control queue bound (429 past it)")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="per-request walltime bound (503 past it)")
    p.add_argument("--stall-timeout", type=float, default=None,
                   help="serve watchdog budget per decode step or static "
                        "batch (0 = off); a hung step dumps the stacks "
                        "and the flight recorder, then exits 70")
    p.add_argument("--scheduler", choices=("static", "slots"), default=None,
                   help="decode driver: 'slots' (default) = continuous "
                        "batching over the slot pool; 'static' = the "
                        "batch-to-completion micro-batcher")
    p.add_argument("--slots", type=int, default=None,
                   help="slot-pool size (0 = largest batch extent)")
    p.add_argument("--kv-layout", choices=("paged", "contiguous"),
                   default=None,
                   help="slot-pool KV layout: 'paged' (default) = page "
                        "pool + radix prefix cache; 'contiguous' = one "
                        "worst-case region per slot")
    p.add_argument("--page-size", type=int, default=None,
                   help="tokens per KV page (also the prefix-cache "
                        "sharing granularity)")
    p.add_argument("--pages", type=int, default=None,
                   help="page-pool size (0 = slots x pages-per-slot)")
    p.add_argument("--attention", choices=("jnp", "pallas"), default=None,
                   help="decode attention: 'jnp' (default) = plain torch "
                        "gather + attention; 'pallas' = the hand-written "
                        "paged-decode kernel")
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                   help="KV page tier under --kv-layout paged: 'int8' "
                        "stores codes + one float32 scale per (token, "
                        "kv-head)")
    p.add_argument("--weights-dtype", choices=("bf16", "int8"),
                   default=None,
                   help="serve-only weight tier: 'int8' quantizes the "
                        "block matrices per output channel at load")
    p.add_argument("--speculation", choices=("off", "lookup", "draft"),
                   default=None,
                   help="speculative decoding: 'lookup' = n-gram "
                        "proposals from each request's history and the "
                        "radix cache, 'draft' = a draft model's "
                        "(--spec-draft-checkpoint); greedy and --kv-layout "
                        "paged only")
    p.add_argument("--spec-k", type=int, default=None,
                   help="proposed tokens verified per slot per step")
    p.add_argument("--spec-draft-checkpoint", default=None,
                   help="draft-model checkpoint (or run) directory for "
                        "--speculation draft")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="TTFT objective behind serve/goodput (0 = every "
                        "request counts good)")
    p.add_argument("--flight-recorder-steps", type=int, default=None,
                   help="engine-step ring dumped on stalls and served at "
                        "/debug/state (0 = off)")
    p.add_argument("--max-replays", type=int, default=None,
                   help="replay budget per request: a poisoned step "
                        "re-queues in-flight requests this many times "
                        "before a 503 (0 = fail on the first fault)")
    p.add_argument("--drain-timeout", type=float, default=None,
                   help="graceful-drain budget (SIGTERM, POST "
                        "/admin/drain): requests still in flight past it "
                        "get 503 and a reason")
    p.add_argument("--watch-checkpoints", type=float, default=None,
                   help="poll the run dir's LATEST every N seconds and "
                        "hot-swap new checkpoints (0 = off; POST "
                        "/admin/reload works either way)")
    p.add_argument("--mesh", default=None,
                   help="serve mesh as AXIS=SIZE pairs over tp/fsdp, "
                        "e.g. 'tp=2,fsdp=2': weights shard Megatron-style "
                        "and KV pages shard on the head dim over the "
                        "processes of a torchrun launch (default: single "
                        "device; '' forces single-device over a config's "
                        "serve.mesh)")
    p.add_argument("--mesh-weights", choices=("fsdp", "replicated"),
                   default=None,
                   help="weight placement under --mesh: 'fsdp' shards "
                        "the second matrix axis (gathered on use), "
                        "'replicated' keeps weights whole per process")
    p.add_argument("--degrade-step-ms", type=float, default=None,
                   help="halve the queue bound while a decode step takes "
                        "longer than this (0 = off)")
    p.add_argument("--no-request-tracing", action="store_true",
                   help="disable per-request lifecycle tracing (the "
                        "serve/ttft|itl|goodput family and the 'trace': "
                        "true response)")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup pass over every admission bucket")
    return p


def load_config_file(path: str) -> dict:
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml  # only YAML configs need pyyaml

        return yaml.safe_load(f)


def serve_config_from_args(args, raw: dict) -> ServeConfig:
    """The config's serve: section with CLI flags layered on top."""
    cfg = ServeConfig.from_dict(raw.get("serve") or {})
    if args.buckets is not None:
        cfg.buckets = parse_buckets(args.buckets)
    if args.mesh is not None:
        cfg.mesh = parse_mesh(args.mesh) or None
    if args.mesh_weights is not None:
        cfg.mesh_weights = args.mesh_weights
    for flag in ("seed", "max_wait_ms", "max_queue", "request_timeout",
                 "stall_timeout", "scheduler", "slots", "kv_layout",
                 "page_size", "pages", "attention", "kv_dtype",
                 "weights_dtype", "slo_ttft_ms", "flight_recorder_steps",
                 "max_replays", "drain_timeout", "watch_checkpoints",
                 "degrade_step_ms", "speculation", "spec_k",
                 "spec_draft_checkpoint", "host", "port"):
        value = getattr(args, flag)
        if value is not None:
            setattr(cfg, flag, value)
    if args.no_request_tracing:
        cfg.request_tracing = False
    return cfg


def build_engine(args) -> InferenceEngine:
    """The engine the parsed flags describe."""
    if args.checkpoint is None and args.config is None:
        raise SystemExit("serve: give --checkpoint or --config")
    raw = load_config_file(args.config) if args.config else {}
    serve_cfg = serve_config_from_args(args, raw)
    if args.checkpoint is not None:
        if args.weights:
            raise SystemExit("serve: --weights and --checkpoint exclude "
                             "each other")
        engine = InferenceEngine.from_checkpoint(
            args.checkpoint,
            config=TRLConfig.from_dict(raw) if raw else None,
            serve=serve_cfg, device=args.device)
        print(f"[trlx_tpu_torch.serve] restored policy from "
              f"{engine.checkpoint_path}", file=sys.stderr, flush=True)
        return engine
    views = load_decode_views(args.weights) if args.weights else None
    return InferenceEngine(TRLConfig.from_dict(raw), serve=serve_cfg,
                           views=views, device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    if engine.channel is not None and not engine.channel.leader:
        from trlx_tpu_torch.serve.follower import serve_follower

        return serve_follower(engine)
    server = InferenceServer(engine).start(warmup=not args.no_warmup)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
