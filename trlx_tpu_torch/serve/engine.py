"""Inference engine: a policy's decode views + the serving lattice (port of
trlx_tpu.serve.engine).

:class:`InferenceEngine` holds what decode reads — the (trunk,
trainable-top) block segments, embed (+ lm_head), ln_f — on one device,
plus the bucket lattice and the paged-pool geometry the slot scheduler
(trlx_tpu_torch.serve.slots) sizes itself from. Weights come in as
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
(trlx_tpu_torch.serve.speculate). Knobs of features not ported yet are
accepted at their defaults and refused otherwise
(:data:`DEFERRED_KNOBS`).
"""

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
from trlx_tpu_torch.utils import DTYPES, resolve_device
from trlx_tpu_torch.utils.tokenizer import load_tokenizer

Bucket = Tuple[int, int, int]  # (batch, prompt_len, gen_len)

_DEFAULT_BUCKETS = ((4, 32, 32), (8, 64, 64))

#: trlx_tpu serve knobs whose features later slices port: a config may
#: carry them at their defaults; any other value is refused rather than
#: silently ignored
DEFERRED_KNOBS: Dict[str, Any] = {
    "tenants": None,  # tenants, quotas and brownout
    "brownout_max_new": 0,
    "mesh": None,  # tp meshes
    "watch_checkpoints": 0.0,  # hot-swap
}


@dataclass
class ServeConfig:
    """The ``serve:`` YAML section / CLI knobs of this slice (trlx_tpu's
    names and defaults).

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
    """

    buckets: List[List[int]] = field(
        default_factory=lambda: [list(b) for b in _DEFAULT_BUCKETS]
    )
    max_wait_ms: float = 20.0
    max_queue: int = 256
    request_timeout: float = 120.0
    host: str = "127.0.0.1"
    port: int = 8080
    seed: int = 0
    scheduler: str = "slots"
    slots: int = 0
    kv_layout: str = "paged"
    page_size: int = 64
    pages: int = 0
    attention: str = "jnp"
    kv_dtype: str = "bf16"
    weights_dtype: str = "bf16"
    speculation: str = "off"
    spec_k: int = 4
    spec_ngram_max: int = 3
    spec_draft_checkpoint: Optional[str] = None
    spec_index_max_keys: int = 512

    @classmethod
    def from_dict(cls, config: Optional[Dict[str, Any]]) -> "ServeConfig":
        config = dict(config or {})
        for knob, default in DEFERRED_KNOBS.items():
            if knob in config and config[knob] != default:
                raise NotImplementedError(
                    f"serve.{knob}={config[knob]!r} is not ported to "
                    f"trlx_tpu_torch yet (only {default!r}); see ROADMAP.md"
                )
        return cls(**filter_known_fields(cls, config))


#: block matmul leaves serve.weights_dtype: int8 quantizes — the stacked
#: [L, in, out] matrices; biases, norms and embeddings stay as they are
_QUANT_WEIGHT_LEAVES = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate")


@torch.no_grad()
def quantize_serve_weights(blocks, device=None):
    """Serve-only int8 weight views: each stacked block matrix
    [L, in, out] becomes a ``(codes int8 [L, in, out], scale float32
    [L, 1, out])`` pair — symmetric per-output-channel quantization,
    consumed by ``transformer._project``. ``device`` (default: each
    leaf's own) is where the pair lands. One layer at a time, so the
    float32 temporary is one [in, out] matrix (the scales are per
    output channel: the result is the stacked computation's). A pair
    already quantized passes through."""

    def quantize(x):
        dev = x.device if device is None else torch.device(device)
        L, n_in, n_out = x.shape
        codes = torch.empty((L, n_in, n_out), dtype=torch.int8, device=dev)
        scale = torch.empty((L, 1, n_out), dtype=torch.float32, device=dev)
        for i in range(L):
            x32 = x[i].to(device=dev, dtype=torch.float32)
            s = x32.abs().amax(dim=0, keepdim=True) / 127.0 + 1e-8
            codes[i] = torch.clamp(torch.round(x32 / s), -127, 127).to(
                torch.int8)
            scale[i] = s
            del x32
        return codes, scale

    def walk(tree):
        if isinstance(tree, dict):
            return {k: quantize(v) if k in _QUANT_WEIGHT_LEAVES
                    and torch.is_tensor(v) and v.dim() == 3 else walk(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if isinstance(tree, tuple) and not (
                len(tree) == 2 and all(torch.is_tensor(m) for m in tree)):
            return tuple(walk(v) for v in tree)
        return tree

    return walk(blocks)


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
    """A policy's decode views on one device + its serving lattice.

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
        self.config = config
        self.checkpoint_path: Optional[str] = None
        self.serve = serve or ServeConfig()
        self._validate()
        self.device = resolve_device(device)
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
        if self.serve.weights_dtype == "int8":
            # quantized from the weights as given (float32 for a numpy
            # tree), on the serving device, a layer at a time
            views = views._replace(blocks=quantize_serve_weights(
                views.blocks, self.device))
        views = views_to(views, self.device, self.compute_dtype)
        self.blocks, self.embed, self.ln_f = views
        n_bytes = sum(
            t.numel() * t.element_size()
            for part in (self.blocks, self.embed, self.ln_f)
            for t in _leaves(part)
        )
        telemetry.set_gauge("serve/model_gb", n_bytes / 2**30)
        #: the static path: one rollout decoder per bucket (its own
        #: graph cache), one sampling stream re-seeded per batch
        self._decoders: Dict[Bucket, Any] = {}
        self._generator = torch.Generator(device=self.device)
        self._lock = threading.Lock()
        self.warmed = False

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

        params, meta, resolved = restore_tensor_component("params",
                                                          checkpoint)
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
        too. Dispatches are serialised by a lock."""
        from trlx_tpu_torch.models.generation import generate

        B, P, G = bucket
        if tokens.shape != (B, P):
            raise ValueError(
                f"decode batch shape {tokens.shape} does not match "
                f"bucket (batch={B}, prompt={P})"
            )
        cfg = self.gen_config._replace(gen_size=G)
        with self._lock, telemetry.span(self.span_name(bucket)):
            self._generator.manual_seed(int(seed))
            out = generate(
                self.spec, self.blocks, self.embed, self.ln_f,
                torch.as_tensor(np.ascontiguousarray(tokens, np.int32),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(mask, np.int32),
                                device=self.device),
                self._generator, cfg, compute_dtype=self.compute_dtype,
                decoder=self._decoder(bucket),
            )
            return type(out)(*(x.cpu().numpy() for x in out))

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
