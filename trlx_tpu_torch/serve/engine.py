"""Inference engine: a policy's decode views + the serving lattice (port of
trlx_tpu.serve.engine).

:class:`InferenceEngine` holds what decode reads — the (trunk,
trainable-top) block segments, embed (+ lm_head), ln_f — on one device
or, under ``serve.mesh``, as this process's slices on a tp x fsdp serve
mesh (trlx_tpu_torch.serve.layouts), plus the bucket lattice and the
paged-pool geometry the slot scheduler (trlx_tpu_torch.serve.slots)
sizes itself from. Weights come in as
:class:`~trlx_tpu_torch.models.params.DecodeViews` (carried across from
a trlx_tpu tree, loaded from a ``torch.save`` file, or a seeded random
init), as a hydra param tree (``params``: a trainer's own tensors serve
where they live, with no copy through the host), from a port checkpoint
(:meth:`InferenceEngine.from_checkpoint`: a checkpoint or run
directory, the config from its meta.json), or, when the config has no
``model.model_spec``, from the pretrained ``model.model_path``
(trlx_tpu_torch.models.hf_import, which also gives the spec). The
engine runs on CUDA unless the caller passes ``device="cpu"``; with no
card it raises.

Knob names and defaults are trlx_tpu's, so a YAML ``serve:`` section
means the same thing to both packages: ``attention: pallas`` names the
hand-written Hopper decode kernel, ``attention: jnp`` (default) the
plain torch gather path; ``scheduler: static`` the batch-to-completion
micro-batcher (trlx_tpu_torch.serve.batcher) over one ``generate`` per
bucket (:meth:`InferenceEngine.decode`), ``slots`` (default) the slot
scheduler; ``kv_layout`` the slot pool's paged or contiguous layout;
``kv_dtype: int8`` the quantized page pool; ``weights_dtype: int8``
per-output-channel int8 block weights (:func:`quantize_serve_weights`);
``speculation: lookup | draft`` speculative decoding
(trlx_tpu_torch.serve.speculate); ``tenants`` / ``brownout_*`` /
``priority_aging_rounds`` / ``degrade_step_ms`` overload containment,
``request_tracing`` / ``slo_*`` / ``flight_recorder_steps`` tracing,
``stall_timeout`` the serve watchdog, ``max_replays`` / ``drain_timeout``
/ ``watch_checkpoints`` the crash-only lifecycle, ``mesh`` /
``mesh_weights`` the tp serve mesh.

The serve mesh is the world of a ``torchrun`` launch, one process per
card. Every process builds the engine from the same config and keeps
its slices of each leaf; process 0 runs the host side (scheduler,
radix cache, HTTP) and every other process mirrors its device calls
(trlx_tpu_torch.serve.follower, over :attr:`InferenceEngine.channel`):
under ``scheduler: slots`` the slot runtime's, under ``scheduler:
static`` the engine's own :meth:`~InferenceEngine.decode` and a
hot-swap's :meth:`~InferenceEngine.install` and
:meth:`~InferenceEngine.end_swap`. With ``mesh`` unset there is no
process group and no collective.

Hot-swap (:meth:`InferenceEngine.install_views`) writes the candidate
INTO the engine's own tensors: the decode graphs captured those tensors,
so a swap that rebound them would make every later replay copy the
whole model into the captured ones. The candidate's tensors get the
previous weights in exchange, which is the rollback copy.
"""

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.method_configs import PPOConfig, filter_known_fields
from trlx_tpu_torch.models.generation import GenerationConfig
from trlx_tpu_torch.models.hf_import import hydra_params_from_trunk
from trlx_tpu_torch.models.params import (
    DecodeViews,
    decode_views_from_numpy,
    init_decode_views,
    views_to,
)
from trlx_tpu_torch.models.policy import HydraPolicy
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.ops.sampling import SamplingParams
from trlx_tpu_torch.serve.batcher import TenantTable
from trlx_tpu_torch.utils import DTYPES, resolve_device
from trlx_tpu_torch.utils.tokenizer import load_tokenizer

Bucket = Tuple[int, int, int]  # (batch, prompt_len, gen_len)

_DEFAULT_BUCKETS = ((4, 32, 32), (8, 64, 64))

@dataclass
class ServeConfig:
    """The ``serve:`` YAML section / CLI knobs (trlx_tpu's names and
    defaults, every field of trlx_tpu's).

    :param buckets: the (batch, prompt_len, gen_len) lattice; requests
        round UP to the smallest (prompt_len, gen_len) class that fits,
        and prefill batches come in the class's batch extents.
    :param max_wait_ms: the static micro-batcher's deadline: a batch is
        flushed when its bucket's largest batch fills or its oldest
        request has waited this long.
    :param max_queue: ``submit`` rejects past this many queued requests
        (HTTP 429).
    :param request_timeout: bound on one request's queue + decode time
        at the HTTP edge (503 past it).
    :param stall_timeout: the serve watchdog's budget for one decode
        step or static batch (trlx_tpu_torch.supervisor, stall action
        ``abort``): a hung step dumps every thread's stack and the
        flight recorder, counts ``fault/stalls``, and exits 70 after
        the grace so a supervisor restarts the replica. 0 disables.
    :param host / port: bind address of the HTTP endpoint.
    :param seed: base sampling seed (each decode step, or static batch,
        uses seed + its counter).
    :param scheduler: ``"slots"`` (default) continuous batching over the
        slot pool; ``"static"`` the batch-to-completion micro-batcher.
    :param slots: slot-pool size; 0 = the largest batch extent.
    :param kv_layout: ``"paged"`` (default) pages + radix prefix cache;
        ``"contiguous"`` one worst-case region per slot.
    :param page_size: tokens per KV page (clamped to the slot buffer);
        also the prefix-cache sharing granularity.
    :param pages: page-pool size; 0 = slots x pages-per-slot.
    :param request_tracing: per-request lifecycle tracing
        (trlx_tpu_torch.serve.trace): the ``serve/ttft`` / ``serve/itl``
        / ``serve/goodput`` family, Perfetto tracks and the opt-in
        ``"trace": true`` response. Host bookkeeping only.
    :param slo_ttft_ms: the TTFT objective in ms behind
        ``serve/goodput`` (0 counts every request good).
    :param slo_target: the goodput objective the windowed burn rates
        are scored against (``slo/burn_rate_*``), in [0, 1).
    :param flight_recorder_steps: ring size of the slot scheduler's
        per-step flight recorder (0 disables).
    :param max_replays: per-request replay budget of crash-only
        recovery: a poisoned step re-queues its in-flight requests with
        their committed tokens up to this many times (then
        ``ReplayExhausted``, 503). 0 fails them at once.
    :param drain_timeout: graceful-drain budget (SIGTERM, ``POST
        /admin/drain``), seconds.
    :param watch_checkpoints: poll interval (s) of the serving run
        directory's ``LATEST``; a new committed step is hot-swapped in
        (0 = off; ``POST /admin/reload`` works either way).
    :param degrade_step_ms: a decode step slower than this marks the
        scheduler degraded (halved queue bound); 0 disables the signal.
    :param tenants: per-tenant quotas ``{tenant: {max_inflight,
        max_queue_share, rps, burst, priority}}`` (None = none); the
        ``"default"`` entry also governs tenants not named.
    :param brownout_max_new: under sustained pressure, clamp
        best-effort tenants' ``max_new_tokens`` to this (0 = off).
    :param brownout_after_s / brownout_recover_s: pressure held this
        long engages brownout; calm this long releases it.
    :param priority_aging_rounds: a queued request gains one priority
        level every this many admission scans (0 = aging off).
    :param attention: decode attention: ``"jnp"`` gathers each slot's
        pages into logical order and runs plain attention (the oracle);
        ``"pallas"`` runs the hand-written paged-decode kernel on the
        card (its plain version on the CPU). Paged layout only.
    :param kv_dtype: ``"bf16"`` (default) or ``"int8"`` pages (codes +
        one float32 scale per (token, kv-head), dequantized in the
        gather or inside the kernel). Paged layout only.
    :param weights_dtype: ``"bf16"`` (default) installs the weights as
        given; ``"int8"`` quantizes the block matrices per output channel
        at load (:func:`quantize_serve_weights`).
    :param speculation: ``"off"`` (default), ``"lookup"`` (n-gram
        proposals from each request's own history and the radix cache)
        or ``"draft"`` (a draft model's, ``spec_draft_checkpoint``),
        verified ``spec_k`` at a time by one ``verify_step``. Paged
        layout and greedy decode only.
    :param spec_k: proposed tokens verified per slot per step.
    :param spec_ngram_max: longest history n-gram the lookup tier
        matches on.
    :param spec_draft_checkpoint: the draft's checkpoint (or run)
        directory for ``speculation: draft``.
    :param spec_index_max_keys: per-slot LRU bound on the lookup tier's
        n-gram keys.
    :param mesh: the tp serve mesh ``{"tp": n, "fsdp": m}`` (None = one
        device, no process group); the world must hold tp x fsdp
        processes.
    :param mesh_weights: the second matrix axis under ``mesh``:
        ``"fsdp"`` shards it (gathered on use), ``"replicated"`` keeps it
        whole on every process.
    """

    buckets: List[List[int]] = field(
        default_factory=lambda: [list(b) for b in _DEFAULT_BUCKETS]
    )
    max_wait_ms: float = 20.0
    max_queue: int = 256
    request_timeout: float = 120.0
    stall_timeout: float = 0.0
    host: str = "127.0.0.1"
    port: int = 8080
    seed: int = 0
    scheduler: str = "slots"
    slots: int = 0
    kv_layout: str = "paged"
    page_size: int = 64
    pages: int = 0
    request_tracing: bool = True
    slo_ttft_ms: float = 500.0
    slo_target: float = 0.99
    flight_recorder_steps: int = 256
    max_replays: int = 2
    drain_timeout: float = 30.0
    watch_checkpoints: float = 0.0
    degrade_step_ms: float = 0.0
    attention: str = "jnp"
    kv_dtype: str = "bf16"
    weights_dtype: str = "bf16"
    tenants: Optional[Dict[str, Dict[str, Any]]] = None
    brownout_max_new: int = 0
    brownout_after_s: float = 2.0
    brownout_recover_s: float = 5.0
    priority_aging_rounds: int = 64
    speculation: str = "off"
    spec_k: int = 4
    spec_ngram_max: int = 3
    spec_draft_checkpoint: Optional[str] = None
    spec_index_max_keys: int = 512
    mesh: Optional[Dict[str, int]] = None
    mesh_weights: str = "fsdp"

    @classmethod
    def from_dict(cls, config: Optional[Dict[str, Any]]) -> "ServeConfig":
        return cls(**filter_known_fields(cls, dict(config or {})))


#: block matmul leaves serve.weights_dtype: int8 quantizes — the stacked
#: [L, in, out] matrices; biases, norms and embeddings stay as they are
_QUANT_WEIGHT_LEAVES = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate")


@torch.no_grad()
def quantize_serve_weights(blocks, device=None, tp=None):
    """Serve-only int8 weight views: each stacked block matrix
    [L, in, out] becomes a ``(codes int8 [L, in, out], scale float32
    [L, 1, out])`` pair — symmetric per-output-channel quantization,
    consumed by ``transformer._project``. ``device`` (default: each
    leaf's own) is where the pair lands. One layer at a time, so the
    float32 temporary is one [in, out] matrix (the scales are per
    output channel: the result is the stacked computation's). A pair
    already quantized passes through.

    ``tp`` (a serve mesh's ``DecodeParallel``): ``blocks`` are this
    process's slices; a channel's max over an input dim that the mesh
    shards is taken over the shards' group, so the codes are the
    single-device ones cut to the slice."""

    def quantize(x, spec):
        dev = x.device if device is None else torch.device(device)
        L, n_in, n_out = x.shape
        codes = torch.empty((L, n_in, n_out), dtype=torch.int8, device=dev)
        scale = torch.empty((L, 1, n_out), dtype=torch.float32, device=dev)
        in_axis = spec[0][1] if spec is not None else None
        for i in range(L):
            x32 = x[i].to(device=dev, dtype=torch.float32)
            amax = x32.abs().amax(dim=0, keepdim=True)
            if in_axis is not None:
                tp.all_reduce_max(amax, in_axis)
            s = amax / 127.0 + 1e-8
            codes[i] = torch.clamp(torch.round(x32 / s), -127, 127).to(
                torch.int8)
            scale[i] = s
            del x32
        return codes, scale

    def walk(tree, specs):
        def sub(key):
            return None if specs is None else specs[key]

        if isinstance(tree, dict):
            return {k: quantize(v, sub(k)) if k in _QUANT_WEIGHT_LEAVES
                    and torch.is_tensor(v) and v.dim() == 3
                    else walk(v, sub(k))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, sub(i)) for i, v in enumerate(tree)]
        if isinstance(tree, tuple) and not (
                len(tree) == 2 and all(torch.is_tensor(m) for m in tree)):
            return tuple(walk(v, sub(i)) for i, v in enumerate(tree))
        return tree

    return walk(blocks, None if tp is None else tp.block_specs)


def _normalize_buckets(buckets) -> Tuple[Bucket, ...]:
    out = []
    for b in buckets:
        t = tuple(int(x) for x in b)
        if len(t) != 3 or any(x <= 0 for x in t):
            raise ValueError(
                f"serve bucket {b!r} is not a positive "
                f"(batch, prompt_len, gen_len) triple"
            )
        out.append(t)
    if not out:
        raise ValueError("serve.buckets must name at least one bucket")
    return tuple(sorted(set(out), key=lambda t: (t[1], t[2], t[0])))


class InferenceEngine:
    """A policy's decode views on one device (or this process's slices
    of them on the serve mesh) + its serving lattice.

    :meth:`decode` serialises its dispatches under a lock (the static
    micro-batcher is its one caller; the lock makes direct use from
    several threads safe rather than fast)."""

    def __init__(self, config: TRLConfig, serve: Optional[ServeConfig] = None,
                 views: Optional[DecodeViews] = None,
                 device: Optional[str] = None, params: Optional[Dict] = None):
        """``views``, else the decode views of the hydra tree ``params``
        (numpy or torch leaves; torch leaves are not copied on their way
        to the views), else the pretrained trunk when the config has no
        ``model.model_spec``, else a seeded random policy
        (``serve.seed``); ``device`` defaults to CUDA (``"cpu"`` runs
        the plain path)."""
        if not isinstance(config.method, PPOConfig):
            raise NotImplementedError(
                f"the inference engine serves hydra (PPO) policies; this "
                f"config's method is '{config.method.name}'"
            )
        if telemetry.current() is None:
            telemetry.start()
        #: the caller's own tensors: an engine leaf that is one of them
        #: is served without a copy, so a hot-swap may not write into it
        given = _tensor_ptrs(views) | _tensor_ptrs(params)
        self.config = config
        self.checkpoint_path: Optional[str] = None
        #: the weight generation: 1 at construction, bumped by
        #: :meth:`commit_version` on each committed hot-swap, stamped
        #: into every request at admission (``serve/model_version``)
        self.model_version = 1
        self.serve = serve or ServeConfig()
        self._validate()
        self.device = resolve_device(device)
        from trlx_tpu_torch.serve import layouts
        from trlx_tpu_torch.serve.follower import HostChannel

        #: the serve mesh (None: one device, no process group) and the
        #: host channel its process 0 mirrors device calls over
        self.mesh = layouts.build_serve_mesh(self.serve.mesh,
                                             self.device.type)
        self.channel = HostChannel() if self.mesh is not None else None
        self.buckets = _normalize_buckets(self.serve.buckets)
        self.tokenizer = load_tokenizer(config.model.tokenizer_path)
        spec, trunk = self._resolve_spec_and_trunk(config)
        k = config.model.num_layers_unfrozen
        for b, p, g in self.buckets:
            if p + g > spec.n_positions:
                raise ValueError(
                    f"serve bucket (batch={b}, prompt={p}, gen={g}) needs "
                    f"{p + g} positions but the model has n_positions="
                    f"{spec.n_positions}"
                )
        self.spec = spec
        self.compute_dtype = DTYPES[config.model.compute_dtype]
        eos = getattr(self.tokenizer, "eos_token_id", -1)
        pad = getattr(self.tokenizer, "pad_token_id", 0) or 0
        gk = dict(config.method.gen_kwargs or {})
        # serving semantics: stop at eos (min_new_tokens=0)
        self.gen_config = GenerationConfig(
            gen_size=1,
            sampling=SamplingParams(
                temperature=float(gk.get("temperature", 1.0)),
                top_k=int(gk.get("top_k", 0) or 0),
                top_p=float(gk.get("top_p", 1.0)),
                do_sample=bool(gk.get("do_sample", True)),
            ),
            eos_token_id=eos if eos is not None else -1,
            pad_token_id=pad,
            min_new_tokens=0,
        )
        if self.serve.speculation != "off" \
                and self.gen_config.sampling.do_sample:
            raise ValueError(
                "serve.speculation requires greedy decode "
                "(gen_kwargs do_sample: false): acceptance compares "
                "proposals against the argmax stream — under sampling "
                "the verified output would not match plain decode"
            )
        self.pad_token_id = pad
        if views is None and params is None and trunk is not None:
            params = hydra_params_from_trunk(
                HydraPolicy(spec, k), *trunk,
                np.random.default_rng(self.serve.seed))
        if views is None and params is not None:
            views = decode_views_from_numpy(params, spec, k)
        elif views is None:
            views = init_decode_views(spec, self.serve.seed, k)
        del params, trunk
        #: the decode step's operators on the mesh (None without one)
        self.tp = None
        if self.mesh is not None:
            self.tp = layouts.DecodeParallel(
                self.mesh, spec, self._template(views),
                self.serve.mesh_weights)
            # each process keeps its slices, as copies of its own
            views = DecodeViews(*layouts.shard_views(
                self.mesh, views, self.serve.mesh_weights))
        if self.serve.weights_dtype == "int8":
            # quantized from the weights as given (float32 for a numpy
            # tree), on the serving device, a layer at a time
            views = views._replace(blocks=quantize_serve_weights(
                views.blocks, self.device, self.tp))
        views = views_to(views, self.device, self.compute_dtype)
        self.blocks, self.embed, self.ln_f = views
        self._borrowed = _tensor_ptrs(views) & given
        n_bytes = sum(
            t.numel() * t.element_size()
            for part in (self.blocks, self.embed, self.ln_f)
            for t in _leaves(part)
        )
        telemetry.set_gauge("serve/model_gb", n_bytes / 2**30)
        telemetry.set_gauge("serve/mesh_devices",
                            self.mesh_info()["devices"])
        telemetry.set_gauge("serve/params_gb_per_device",
                            self._params_bytes() / 2**30)
        #: the static path: one rollout decoder per bucket (its own
        #: graph cache), one sampling stream re-seeded per batch
        self._decoders: Dict[Bucket, Any] = {}
        self._generator = torch.Generator(device=self.device)
        #: serialises the static path's decodes and its weight swaps (a
        #: swap's probe decodes while holding it), and so their order on
        #: the serve mesh's host channel
        self._lock = threading.RLock()
        self.warmed = False
        #: sha-256 of every static decode's tokens and mask on this
        #: process: equal on every process of a mesh that kept in step
        self.digest = hashlib.sha256()
        #: during a hot-swap, the candidate's tensors (holding the
        #: previous weights once installed): the rollback copy
        self._held = None

    def _template(self, views) -> DecodeViews:
        """The serving views' leaves as meta tensors of their whole
        shapes, quantized as ``weights_dtype`` says: what the mesh
        placements are fitted to."""
        meta = DecodeViews(*tree_map(
            lambda t: torch.empty(tuple(t.shape), device="meta"),
            tuple(views)))
        if self.serve.weights_dtype == "int8":
            meta = meta._replace(blocks=quantize_serve_weights(
                meta.blocks, "meta"))
        return meta

    def _params_bytes(self) -> int:
        from trlx_tpu_torch.serve import layouts

        return layouts.tree_bytes_per_device(
            (self.blocks, self.embed, self.ln_f))

    def mesh_info(self) -> Dict[str, Any]:
        """The serve-mesh block /healthz and /debug/state report: axis
        names and sizes, device count, weight placement, and the params
        GB each process holds (what capacity planning sizes against)."""
        from trlx_tpu_torch.serve import layouts

        info = layouts.mesh_info(self.mesh, self.serve.mesh_weights)
        if getattr(self, "blocks", None) is not None:
            info["params_gb_per_device"] = round(
                self._params_bytes() / 2**30, 6)
        return info

    @staticmethod
    def _resolve_spec_and_trunk(config: TRLConfig):
        """(spec, pretrained trunk | None), as the trainers'
        ``_load_or_spec``: an explicit ``model.model_spec`` wins;
        otherwise the HF import of ``model.model_path`` gives the spec
        and the weights (which a checkpoint's params then replace)."""
        if config.model.model_spec is not None:
            return config.model.resolve_spec(), None
        from trlx_tpu_torch.models.hf_import import load_trunk_from_hf

        try:
            spec, embed, blocks, ln_f = load_trunk_from_hf(
                config.model.model_path)
        except Exception as e:
            raise RuntimeError(
                f"could not resolve the model architecture for serving: "
                f"pretrained load of '{config.model.model_path}' failed "
                f"({e!r}) and the config has no model.model_spec. Serve "
                f"from a config whose model section matches the "
                f"checkpoint's (the checkpoint's own meta.json 'config' "
                f"component has it for checkpoints saved by this "
                f"framework).") from e
        return spec, (embed, blocks, ln_f)

    @classmethod
    def from_checkpoint(cls, checkpoint: str,
                        config: Optional[TRLConfig] = None,
                        serve: Optional[ServeConfig] = None,
                        device: Optional[str] = None,
                        ) -> "InferenceEngine":
        """An engine on a PPO checkpoint of the port's trainer:
        ``checkpoint`` is a checkpoint directory or a run directory (its
        newest committed ``step_<N>``, falling back past a corrupt one).
        Only the ``params`` component is read and verified; the config is
        the one the trainer embedded in meta.json unless ``config`` is
        given. The decode views are built from the restored params."""
        from trlx_tpu_torch.utils.checkpoint import restore_tensor_component

        params, meta, resolved = restore_tensor_component(
            "params", checkpoint, mmap=bool(serve is not None and serve.mesh))
        if config is None:
            if "config" not in meta:
                raise ValueError(
                    f"checkpoint '{resolved}' carries no embedded config; "
                    f"pass the training config explicitly (--config)")
            config = TRLConfig.from_dict(meta["config"])
        if not isinstance(config.method, PPOConfig):
            raise NotImplementedError(
                f"the inference engine serves hydra (PPO) policies; the "
                f"checkpoint's method is '{config.method.name}'")
        engine = cls(config, serve=serve, device=device, params=params)
        engine.checkpoint_path = resolved
        engine._borrowed = set()  # the restored tree is the engine's alone
        return engine

    def _validate(self) -> None:
        """trlx_tpu's construction checks of the ported knobs, message for
        message."""
        s = self.serve
        if s.scheduler not in ("static", "slots"):
            raise ValueError(
                f"serve.scheduler '{s.scheduler}' is not one of: "
                f"static, slots"
            )
        if s.slots < 0:
            raise ValueError(f"serve.slots={s.slots} must be >= 0 (0 = auto)")
        if s.kv_layout not in ("paged", "contiguous"):
            raise ValueError(
                f"serve.kv_layout '{s.kv_layout}' is not one of: "
                f"paged, contiguous"
            )
        if s.page_size < 1:
            raise ValueError(f"serve.page_size={s.page_size} must be >= 1")
        if s.pages < 0:
            raise ValueError(f"serve.pages={s.pages} must be >= 0 (0 = auto)")
        if s.slo_ttft_ms < 0:
            raise ValueError(
                f"serve.slo_ttft_ms={s.slo_ttft_ms} must be >= 0 "
                f"(0 = every completed request counts toward goodput)"
            )
        if not 0.0 <= s.slo_target < 1.0:
            raise ValueError(
                f"serve.slo_target={s.slo_target} must be in "
                f"[0, 1) — 1.0 leaves no error budget to burn"
            )
        if s.flight_recorder_steps < 0:
            raise ValueError(
                f"serve.flight_recorder_steps="
                f"{s.flight_recorder_steps} must be >= 0 "
                f"(0 = disabled)"
            )
        if s.max_replays < 0:
            raise ValueError(
                f"serve.max_replays={s.max_replays} must be >= 0 "
                f"(0 = a poisoned step fails its requests, no replay)"
            )
        if s.drain_timeout <= 0:
            raise ValueError(
                f"serve.drain_timeout={s.drain_timeout} must be "
                f"> 0 (a drain with no budget is just SIGKILL)"
            )
        if s.watch_checkpoints < 0:
            raise ValueError(
                f"serve.watch_checkpoints={s.watch_checkpoints} "
                f"must be >= 0 (0 = no polling; POST /admin/reload only)"
            )
        if s.degrade_step_ms < 0:
            raise ValueError(
                f"serve.degrade_step_ms={s.degrade_step_ms} "
                f"must be >= 0 (0 = step-time degradation signal off)"
            )
        if s.brownout_max_new < 0:
            raise ValueError(
                f"serve.brownout_max_new={s.brownout_max_new} "
                f"must be >= 0 (0 = brownout degradation off)"
            )
        if s.brownout_after_s <= 0:
            raise ValueError(
                f"serve.brownout_after_s={s.brownout_after_s} "
                f"must be > 0 (pressure debounce before brownout)"
            )
        if s.brownout_recover_s <= 0:
            raise ValueError(
                f"serve.brownout_recover_s="
                f"{s.brownout_recover_s} must be > 0 "
                f"(hysteresis: calm time required before recovery)"
            )
        if s.priority_aging_rounds < 0:
            raise ValueError(
                f"serve.priority_aging_rounds="
                f"{s.priority_aging_rounds} must be >= 0 "
                f"(0 = priority aging off)"
            )
        if s.tenants is not None:
            # parsed eagerly, so a bad tenants block fails at boot with a
            # config-shaped error, not at first admission
            TenantTable(s.tenants, s.max_queue)
        if s.mesh_weights not in ("fsdp", "replicated"):
            raise ValueError(
                f"serve.mesh_weights '{s.mesh_weights}' is not "
                f"one of: fsdp, replicated"
            )
        if s.attention not in ("jnp", "pallas"):
            raise ValueError(
                f"serve.attention '{s.attention}' is not one of: jnp, pallas"
            )
        if s.kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"serve.kv_dtype '{s.kv_dtype}' is not one of: bf16, int8"
            )
        if s.weights_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"serve.weights_dtype '{s.weights_dtype}' is not one of: "
                f"bf16, int8"
            )
        if s.speculation not in ("off", "lookup", "draft"):
            raise ValueError(
                f"serve.speculation '{s.speculation}' is not one of: "
                f"off, lookup, draft"
            )
        if s.spec_k < 1:
            raise ValueError(
                f"serve.spec_k={s.spec_k} must be >= 1 (disable "
                f"speculation with serve.speculation: off)"
            )
        if s.spec_ngram_max < 1:
            raise ValueError(
                f"serve.spec_ngram_max={s.spec_ngram_max} must be >= 1"
            )
        if s.spec_index_max_keys < 1:
            raise ValueError(
                f"serve.spec_index_max_keys={s.spec_index_max_keys} must "
                f"be >= 1 (the per-slot n-gram index needs at least one "
                f"key)"
            )
        if s.speculation == "draft" and not s.spec_draft_checkpoint:
            raise ValueError(
                "serve.speculation 'draft' needs serve.spec_draft_checkpoint "
                "(the draft model to propose with) — or use speculation: "
                "lookup"
            )
        if s.kv_layout != "paged":
            if s.attention == "pallas":
                raise ValueError(
                    "serve.attention 'pallas' is the PAGED decode kernel; "
                    f"kv_layout '{s.kv_layout}' has no paged pool to walk "
                    "— use kv_layout: paged or attention: jnp"
                )
            if s.kv_dtype != "bf16":
                raise ValueError(
                    "serve.kv_dtype 'int8' quantizes PAGED pool pages; "
                    f"kv_layout '{s.kv_layout}' supports bf16 only"
                )
            if s.speculation != "off":
                raise ValueError(
                    "serve.speculation verifies candidates through the "
                    "PAGED pool's per-slot page tables; kv_layout "
                    f"'{s.kv_layout}' cannot re-claim rejected writes — "
                    "use kv_layout: paged or speculation: off"
                )

    # -- live hot-swap -------------------------------------------------- #

    def strip_for_serve(self, params: Dict) -> DecodeViews:
        """A hydra param tree (numpy or torch leaves; a checkpoint's
        decode subset from :meth:`load_params`, on the serve mesh this
        process's slices of it) reduced to decode views the way
        construction does it — int8-quantized under
        ``weights_dtype: int8``, on the serving device in the compute
        dtype — WITHOUT installing them: the candidate must pass
        :meth:`validate_swap` and a smoke probe first. Installing
        exchanges contents with the live weights, so a leaf of ``params``
        that would come through unchanged is copied — unless it IS the
        serving tensor (an engine built on that same tree), which the
        install leaves alone."""
        given = _tensor_ptrs(params) - _tensor_ptrs(
            (self.blocks, self.embed, self.ln_f))
        views = decode_views_from_numpy(params, self.spec,
                                        self.config.model.num_layers_unfrozen)
        if self.serve.weights_dtype == "int8":
            views = views._replace(blocks=quantize_serve_weights(
                views.blocks, self.device, self.tp))
        views = views_to(views, self.device, self.compute_dtype)
        return type(views)(*tree_map(
            lambda t: t.clone() if _ptr(t) in given else t, tuple(views)))

    def validate_swap(self, views) -> None:
        """Reject a candidate that does not match the serving views leaf
        for leaf in structure, shape and dtype (the graphs captured
        those; drift needs a restart, not a reload), and one that would
        change a tensor the engine serves without owning it (its
        caller's, passed in as views or params): the swap writes in
        place, so it would write into the caller's weights."""
        from trlx_tpu_torch.utils.aotjit import tree_flatten

        old_leaves, old_struct = tree_flatten(
            (self.blocks, self.embed, self.ln_f))
        new_leaves, new_struct = tree_flatten(tuple(views))
        if old_struct != new_struct:
            raise ValueError(
                "hot-swap rejected: candidate param tree structure does "
                "not match the serving policy (architecture drift — e.g. "
                "a different model or num_layers_unfrozen). Restart the "
                "endpoint against the new checkpoint instead."
            )
        for o, n in zip(old_leaves, new_leaves):
            if o.shape != n.shape or o.dtype != n.dtype:
                raise ValueError(
                    f"hot-swap rejected: candidate leaf {tuple(n.shape)}/"
                    f"{n.dtype} does not match serving leaf "
                    f"{tuple(o.shape)}/{o.dtype} — shape/dtype drift "
                    f"would force a recompile; restart the endpoint "
                    f"instead."
                )
        written = [o for o, n in zip(old_leaves, new_leaves)
                   if _ptr(o) in self._borrowed and _ptr(n) != _ptr(o)]
        if written:
            raise ValueError(
                f"hot-swap rejected: it would write {len(written)} serving "
                f"tensors that are the caller's own (the engine was built on "
                f"views or params already on {self.device} in the compute "
                f"dtype, and serves them without a copy); a swap writes "
                f"in place, so it would write into them. Build the engine "
                f"from a checkpoint (InferenceEngine.from_checkpoint) or "
                f"from copies."
            )

    @torch.no_grad()
    def install_views(self, views) -> None:
        """Install validated decode views IN PLACE: each serving tensor
        takes the candidate's values and the candidate's tensor takes
        the previous ones, so the captured graphs keep reading the same
        addresses (zero recompiles, no per-replay copy) and ``views``
        is the rollback: installing it again restores the weights.
        A leaf that is already the serving tensor is left alone."""
        from trlx_tpu_torch.utils.aotjit import tree_flatten

        live, _ = tree_flatten((self.blocks, self.embed, self.ln_f))
        cand, _ = tree_flatten(tuple(views))
        for old, new in zip(live, cand):
            if new is old or (new.numel() and new.data_ptr() == old.data_ptr()):
                continue
            held = old.clone()
            old.copy_(new)
            new.copy_(held)
            del held

    def check_graph_transport(self) -> None:
        """Refuse decode graphs on a serve mesh whose collectives run over
        gloo with CUDA tensors: a gloo collective cannot be captured.
        Called where a decode driver is built (the slot runtime, the
        static micro-batcher, a static follower), so it is refused
        before serving, never replayed eager in silence."""
        import torch.distributed as dist

        from trlx_tpu_torch.utils import aotjit

        if self.tp is not None and self.device.type == "cuda" \
                and aotjit.CUDA_GRAPHS and dist.get_backend() != "nccl":
            raise RuntimeError(
                "the serve mesh's collectives run over gloo here, which a "
                "CUDA graph cannot capture: serve on the card with an NCCL "
                "process group (one process per card), or turn the decode "
                "graphs off (trlx_tpu_torch.utils.aotjit.CUDA_GRAPHS = "
                "False)")

    def _mirror(self, op: str, *args) -> None:
        """Process 0 of a serve mesh publishes a device call to the
        followers before running it (a no-op elsewhere)."""
        if self.channel is not None and self.channel.leader:
            self.channel.send(op, *args)

    def close(self) -> None:
        """End the followers' loops (process 0 of a serve mesh; the first
        call only). No device call may follow it on a mesh of several
        processes."""
        if self.channel is not None and self.channel.leader:
            self.channel.close()

    def install(self, checkpoint: str, views=None) -> None:
        """A hot-swap's install (:meth:`install_views`), in place;
        ``views`` is kept as the rollback copy until :meth:`end_swap`.
        Without ``views`` (a follower) this process restores, strips and
        validates its own slices of ``checkpoint``; on a mesh of several
        processes, process 0 publishes the checkpoint it took the
        candidate from, so each follower restores its slices of it."""
        if views is None:
            params, _ = self.load_params(checkpoint)
            views = self.strip_for_serve(params)
            del params
            self.validate_swap(views)
        elif self.channel is not None and self.channel.world > 1:
            if not checkpoint:
                raise ValueError(
                    "a hot-swap on a serve mesh of several processes needs "
                    "the checkpoint directory the candidate came from "
                    "(each process restores its own slices of it)")
            self._mirror("install", checkpoint)
        self.install_views(views)
        self._held = views

    def end_swap(self, rollback: bool) -> None:
        """End a hot-swap: with ``rollback`` the previous weights go back
        in (the held candidate holds them); either way the rollback copy
        is dropped."""
        self._mirror("end_swap", bool(rollback))
        held, self._held = self._held, None
        if rollback and held is not None:
            self.install_views(held)

    def commit_version(self, checkpoint: Optional[str] = None) -> int:
        """Bump the model version AFTER a successful swap and probe; a
        rolled-back swap never commits, so the gauge always names the
        weights actually serving."""
        self.model_version += 1
        if checkpoint:
            self.checkpoint_path = checkpoint
        telemetry.set_gauge("serve/model_version", self.model_version)
        return self.model_version

    def load_params(self, checkpoint: str):
        """The decode subset of a port checkpoint's ``params`` component
        for a hot-swap: (tree, resolved checkpoint directory).
        ``checkpoint`` is a committed checkpoint directory or a run
        directory (its newest committed ``step_<N>``). The component's
        bytes are verified against the manifest first; a corrupt one is
        quarantined and raises ``CheckpointCorrupt`` — fail-fast, with
        no fallback to an older step: the old weights keep serving and
        ``/admin/reload`` answers 409. The file is memory-mapped and
        only the decode subset (the trunk, the trainable blocks, ln_f
        and an untied lm_head; no reference branch, no value head) is
        returned, so the rest is never read from disk. On the serve mesh
        each leaf is this process's slice under the decode placements
        (trlx_tpu_torch.serve.layouts), copied out of the mapping, so a
        process reads its slices only."""
        import os

        from trlx_tpu_torch.utils.checkpoint import (
            TENSOR_SUFFIX,
            find_latest_checkpoint,
            is_valid_checkpoint,
            verify_or_quarantine,
        )

        resolved = checkpoint if is_valid_checkpoint(checkpoint) \
            else find_latest_checkpoint(checkpoint)
        if resolved is None:
            raise FileNotFoundError(
                f"no committed checkpoint at '{checkpoint}' to reload "
                f"from (expected a checkpoint dir or a run dir of "
                f"'step_<N>' checkpoints)"
            )
        resolved = os.path.abspath(resolved)
        verify_or_quarantine(resolved, component="params")
        tree = torch.load(os.path.join(resolved, "params" + TENSOR_SUFFIX),
                          map_location="cpu", weights_only=True, mmap=True)
        trainable = {k: v for k, v in tree["trainable"].items()
                     if k != "v_head"}
        telemetry.inc("checkpoint/restores")
        subset = {"frozen_base": tree["frozen_base"], "trainable": trainable}
        if self.mesh is not None:
            from trlx_tpu_torch.serve import layouts
            from trlx_tpu_torch.utils.checkpoint import slice_tree

            subset = slice_tree(subset, layouts.decode_slicer(
                self.mesh, self.serve.mesh_weights))
        return subset, resolved

    # -- bucket lattice ------------------------------------------------- #

    def shape_classes(self) -> Tuple[Tuple[int, int], ...]:
        """Distinct (prompt_len, gen_len) classes, smallest first."""
        seen = []
        for _, p, g in self.buckets:
            if (p, g) not in seen:
                seen.append((p, g))
        return tuple(seen)

    def pick_shape(self, prompt_len: int,
                   max_new_tokens: int) -> Tuple[int, int]:
        """Smallest (prompt_len, gen_len) class fitting the request;
        ValueError (HTTP 400) when nothing fits."""
        for p, g in self.shape_classes():
            if prompt_len <= p and max_new_tokens <= g:
                return (p, g)
        raise ValueError(
            f"request (prompt_len={prompt_len}, max_new_tokens="
            f"{max_new_tokens}) fits no serve bucket; lattice shape "
            f"classes (prompt, gen): {list(self.shape_classes())}"
        )

    def batch_sizes_for(self, shape: Tuple[int, int]) -> Tuple[int, ...]:
        """Ascending batch extents of one shape class."""
        return tuple(sorted(
            b for b, p, g in self.buckets if (p, g) == shape
        ))

    def default_max_new_tokens(self) -> int:
        return min(g for _, _, g in self.buckets)

    def prompt_classes(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Distinct prompt lengths with their admission batch extents."""
        classes: Dict[int, set] = {}
        for b, p, _ in self.buckets:
            classes.setdefault(p, set()).add(b)
        return tuple((p, tuple(sorted(classes[p]))) for p in sorted(classes))

    def prefill_batch_sizes(self, prompt_len: int) -> Tuple[int, ...]:
        for p, extents in self.prompt_classes():
            if p == prompt_len:
                return extents
        raise ValueError(
            f"prompt_len {prompt_len} is not a prompt class "
            f"(have {[p for p, _ in self.prompt_classes()]})"
        )

    def slot_count(self) -> int:
        return self.serve.slots or max(b for b, _, _ in self.buckets)

    def slot_buffer_len(self) -> int:
        """Per-slot KV extent: the largest prompt+gen any bucket needs."""
        return max(p + g for _, p, g in self.buckets)

    # -- paged-pool geometry -------------------------------------------- #

    def page_size_tokens(self) -> int:
        """``serve.page_size`` clamped to the slot buffer length."""
        return min(self.serve.page_size, self.slot_buffer_len())

    def pages_per_slot(self) -> int:
        ps = self.page_size_tokens()
        return -(-self.slot_buffer_len() // ps)

    def page_count(self) -> int:
        return self.serve.pages or self.slot_count() * self.pages_per_slot()

    def request_page_need(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages one request reserves at admission."""
        ps = self.page_size_tokens()
        return -(-(prompt_len + max_new_tokens) // ps)

    # -- the static path: one generate per bucket ----------------------- #

    def _decoder(self, bucket: Bucket):
        """The bucket's rollout decoder: each bucket owns its own graph
        cache, so warming bucket N + 1 is a first capture, never a
        steady-state miss, and any later ``compile/recompiles`` is a
        real drift."""
        from trlx_tpu_torch.models.generation import RolloutDecoder

        dec = self._decoders.get(bucket)
        if dec is None:
            dec = self._decoders[bucket] = RolloutDecoder()
        return dec

    def span_name(self, bucket: Bucket) -> str:
        B, P, G = bucket
        return f"serve/decode_b{B}p{P}g{G}"

    @torch.no_grad()
    def decode(self, bucket: Bucket, tokens: np.ndarray, mask: np.ndarray,
               seed: int = 0):
        """Run one bucket-shaped batch through ``generate`` (the static
        micro-batcher's flush): tokens / mask are left-padded [B, P]
        int32; returns the GenerationOutput as host numpy. The span
        closes after the copy to the host, so it times the device work
        too. Dispatches are serialised by a lock, under which process 0
        of a serve mesh publishes the call first, so the followers run
        every decode in process 0's order; every process then draws from
        the same seed and ends its loop at the same step."""
        from trlx_tpu_torch.models.generation import generate

        B, P, G = bucket
        if tokens.shape != (B, P):
            raise ValueError(
                f"decode batch shape {tokens.shape} does not match "
                f"bucket (batch={B}, prompt={P})"
            )
        tokens = np.ascontiguousarray(tokens, np.int32)
        mask = np.ascontiguousarray(mask, np.int32)
        cfg = self.gen_config._replace(gen_size=G)
        with self._lock, telemetry.span(self.span_name(bucket)):
            self._mirror("decode", (B, P, G), tokens, mask, int(seed))
            self._generator.manual_seed(int(seed))
            out = generate(
                self.spec, self.blocks, self.embed, self.ln_f,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(mask, device=self.device),
                self._generator, cfg, compute_dtype=self.compute_dtype,
                decoder=self._decoder(bucket), tp=self.tp,
            )
            out = type(out)(*(x.cpu().numpy() for x in out))
            self.digest.update(out.gen_tokens.tobytes())
            self.digest.update(out.gen_mask.tobytes())
            return out

    def warmup(self) -> Dict[str, float]:
        """Run every lattice bucket once, so no live request pays the
        first call (on the card: each bucket's step captured once).
        Returns {bucket span: first-call seconds}."""
        latencies = {}
        for bucket in self.buckets:
            B, P, G = bucket
            tokens = np.full((B, P), self.pad_token_id, np.int32)
            tokens[:, -1] = 0
            mask = np.zeros((B, P), np.int32)
            mask[:, -1] = 1
            self.decode(bucket, tokens, mask, seed=0)
            tel = telemetry.current()
            if tel is not None:
                hist = tel.registry.hists.get(
                    f"time/{self.span_name(bucket)}")
                if hist is not None and hist.first is not None:
                    latencies[self.span_name(bucket)] = hist.first
        self.warmed = True
        telemetry.set_gauge("serve/buckets_warmed", len(self.buckets))
        return latencies

    def graphs(self):
        """Every captured graph of the static path (capture seconds,
        pool bytes)."""
        return [g for dec in self._decoders.values()
                for g in dec.step.graphs()]

    # -- request shaping ------------------------------------------------ #

    def encode_prompt(self, prompt: str) -> List[int]:
        return [int(t) for t in self.tokenizer.encode(prompt)]

    def pad_batch(self, rows: Sequence[Sequence[int]], bucket: Bucket
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Left-pad token rows into the bucket's [B, P] shape; rows short
        of B are filled by repeating the first row."""
        B, P, _ = bucket
        if len(rows) > B or not rows:
            raise ValueError(f"{len(rows)} rows for a batch-{B} bucket")
        tokens = np.full((B, P), self.pad_token_id, np.int32)
        mask = np.zeros((B, P), np.int32)
        for i in range(B):
            row = list(rows[i] if i < len(rows) else rows[0])[-P:]
            tokens[i, P - len(row):] = row
            mask[i, P - len(row):] = 1
        return tokens, mask

    def depad_row(self, out, row: int, max_new_tokens: int) -> List[int]:
        """One request's completion from a batched GenerationOutput: the
        row's generated tokens, cut to its own ``max_new_tokens`` and
        where ``gen_mask`` ends (eos included, pads after excluded)."""
        gen = np.asarray(out.gen_tokens[row])[:max_new_tokens]
        gmask = np.asarray(out.gen_mask[row])[:max_new_tokens]
        return [int(t) for t, m in zip(gen, gmask) if m]


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _ptr(t) -> int:
    """A tensor's storage address, 0 for an empty one (which holds no
    bytes to share)."""
    return t.data_ptr() if torch.is_tensor(t) and t.numel() else 0


def _tensor_ptrs(tree) -> set:
    """Storage addresses of the torch tensors in a nested tree of dicts,
    lists and tuples (numpy and other leaves ignored)."""
    from trlx_tpu_torch.utils.aotjit import tree_flatten

    return {_ptr(x) for x in tree_flatten(tree)[0]} - {0}
