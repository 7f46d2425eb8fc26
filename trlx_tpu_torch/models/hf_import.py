"""Import HuggingFace checkpoints into the port's parameter trees (port of
trlx_tpu.models.hf_import).

The converters take a torch ``state_dict`` and return the port's
``(embed, stacked blocks, ln_f)`` trunk layout as torch tensors on the
state dict's own device, tensor by tensor: a state dict that lives on
the card converts on the card, and no weight passes through numpy. By
default every leaf is float32, as trlx_tpu's converters make it;
``dtype=None`` keeps each tensor's own dtype (a bf16 checkpoint then
converts in half the memory, and the trainer's float32 casts give the
same tree).

:func:`load_trunk_from_hf` reads a local checkpoint directory (or a
model the local HF cache holds) with ``transformers``, imported inside
it; without ``transformers`` the load raises, as any failed load does.
:func:`hydra_params_from_trunk` and :func:`ilql_params_from_trunk`
assemble the trainers' trees from an imported trunk, with fresh heads
drawn from a numpy generator.

Supported arches: gpt2, gptj (gpt-j-6B), gptneox, llama (grouped-query
attention included).
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.heads import init_head_params
from trlx_tpu_torch.models.ilql import split_embed_for_unfreeze
from trlx_tpu_torch.models.transformer import tree_map

Params = Dict[str, Any]


def spec_from_hf_config(hf_config) -> ModelSpec:
    """A ModelSpec from a transformers config object."""
    mt = hf_config.model_type
    if mt == "gpt2":
        return ModelSpec(
            arch="gpt2",
            vocab_size=hf_config.vocab_size,
            n_layer=hf_config.n_layer,
            n_head=hf_config.n_head,
            d_model=hf_config.n_embd,
            n_positions=hf_config.n_positions,
            layer_norm_epsilon=hf_config.layer_norm_epsilon,
            tie_lm_head=True,
        )
    if mt == "gptj":
        return ModelSpec(
            arch="gptj",
            vocab_size=hf_config.vocab_size,
            n_layer=hf_config.n_layer,
            n_head=hf_config.n_head,
            d_model=hf_config.n_embd,
            n_positions=hf_config.n_positions,
            rotary_dim=hf_config.rotary_dim or 0,
            layer_norm_epsilon=hf_config.layer_norm_epsilon,
            tie_lm_head=False,
        )
    if mt == "gpt_neox":
        return ModelSpec(
            arch="gptneox",
            vocab_size=hf_config.vocab_size,
            n_layer=hf_config.num_hidden_layers,
            n_head=hf_config.num_attention_heads,
            d_model=hf_config.hidden_size,
            d_ff=hf_config.intermediate_size,
            n_positions=hf_config.max_position_embeddings,
            rotary_dim=int(
                hf_config.rotary_pct * hf_config.hidden_size
                // hf_config.num_attention_heads
            ),
            layer_norm_epsilon=hf_config.layer_norm_eps,
            tie_lm_head=False,
        )
    if mt == "llama":
        # fail fast on structures the converter does not carry: dropping
        # them silently would give wrong logits with no error
        if getattr(hf_config, "rope_scaling", None):
            raise ValueError(
                "llama checkpoints with rope_scaling (llama-3.1+) are not "
                "supported yet: plain rope frequencies would silently "
                "diverge from the reference model"
            )
        if getattr(hf_config, "attention_bias", False) or getattr(
            hf_config, "mlp_bias", False
        ):
            raise ValueError(
                "llama-arch checkpoints with attention_bias/mlp_bias are "
                "not supported: the converter would silently drop the bias "
                "tensors"
            )
        return ModelSpec(
            arch="llama",
            vocab_size=hf_config.vocab_size,
            n_layer=hf_config.num_hidden_layers,
            n_head=hf_config.num_attention_heads,
            d_model=hf_config.hidden_size,
            d_ff=hf_config.intermediate_size,
            n_positions=hf_config.max_position_embeddings,
            layer_norm_epsilon=hf_config.rms_norm_eps,
            tie_lm_head=getattr(hf_config, "tie_word_embeddings", False),
            n_kv_heads=hf_config.num_key_value_heads,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        )
    raise ValueError(f"unsupported HF model_type '{mt}'")


class _Reader:
    """Reads a state dict's tensors detached, on their own device, in
    ``dtype`` (None keeps each tensor's)."""

    def __init__(self, sd, dtype):
        self.sd, self.dtype = sd, dtype

    def __call__(self, name: str) -> torch.Tensor:
        t = self.sd[name].detach()
        return t if self.dtype is None else t.to(self.dtype)

    def stack(self, fmt: str, n: int, transpose: bool = False):
        """[n, ...] from the tensors ``fmt.format(i=i)``, each transposed
        ([out, in] -> [in, out]) when asked."""
        rows = [self(fmt.format(i=i)) for i in range(n)]
        return torch.stack([r.t() if transpose else r for r in rows])

    def zeros(self, n: int, like: str) -> torch.Tensor:
        ref = self.sd[like]
        return torch.zeros((n,), dtype=self.dtype or ref.dtype,
                           device=ref.device)


def convert_gpt2_state_dict(sd, spec: ModelSpec, dtype=torch.float32
                            ) -> Tuple[Params, Params, Params]:
    """GPT-2: Conv1D weights are already [in, out]; c_attn fuses the q, k,
    v columns."""
    r = _Reader(sd, dtype)
    L, D = spec.n_layer, spec.d_model
    qkv_w = r.stack("transformer.h.{i}.attn.c_attn.weight", L)  # [L, D, 3D]
    qkv_b = r.stack("transformer.h.{i}.attn.c_attn.bias", L)  # [L, 3D]
    embed = {"wte": r("transformer.wte.weight"),
             "wpe": r("transformer.wpe.weight")}
    blocks = {
        "ln_1": {"scale": r.stack("transformer.h.{i}.ln_1.weight", L),
                 "bias": r.stack("transformer.h.{i}.ln_1.bias", L)},
        "ln_2": {"scale": r.stack("transformer.h.{i}.ln_2.weight", L),
                 "bias": r.stack("transformer.h.{i}.ln_2.bias", L)},
        "attn": {
            "wq": qkv_w[:, :, :D].contiguous(),
            "wk": qkv_w[:, :, D:2 * D].contiguous(),
            "wv": qkv_w[:, :, 2 * D:].contiguous(),
            "bq": qkv_b[:, :D].contiguous(),
            "bk": qkv_b[:, D:2 * D].contiguous(),
            "bv": qkv_b[:, 2 * D:].contiguous(),
            "wo": r.stack("transformer.h.{i}.attn.c_proj.weight", L),
            "bo": r.stack("transformer.h.{i}.attn.c_proj.bias", L),
        },
        "mlp": {
            "w_in": r.stack("transformer.h.{i}.mlp.c_fc.weight", L),
            "b_in": r.stack("transformer.h.{i}.mlp.c_fc.bias", L),
            "w_out": r.stack("transformer.h.{i}.mlp.c_proj.weight", L),
            "b_out": r.stack("transformer.h.{i}.mlp.c_proj.bias", L),
        },
    }
    ln_f = {"scale": r("transformer.ln_f.weight"),
            "bias": r("transformer.ln_f.bias")}
    return embed, blocks, ln_f


def convert_gptj_state_dict(sd, spec: ModelSpec, dtype=torch.float32
                            ) -> Tuple[Params, Params, Params]:
    """GPT-J: nn.Linear weights are [out, in] -> transposed; no attention
    biases; one shared ln_1; an untied lm_head with a bias."""
    r = _Reader(sd, dtype)
    L = spec.n_layer
    h = "transformer.h.{i}."
    embed = {
        "wte": r("transformer.wte.weight"),
        "lm_head": {"w": r("lm_head.weight").t().contiguous(),
                    "b": r("lm_head.bias")},
    }
    blocks = {
        "ln_1": {"scale": r.stack(h + "ln_1.weight", L),
                 "bias": r.stack(h + "ln_1.bias", L)},
        "attn": {
            "wq": r.stack(h + "attn.q_proj.weight", L, True),
            "wk": r.stack(h + "attn.k_proj.weight", L, True),
            "wv": r.stack(h + "attn.v_proj.weight", L, True),
            "wo": r.stack(h + "attn.out_proj.weight", L, True),
        },
        "mlp": {
            "w_in": r.stack(h + "mlp.fc_in.weight", L, True),
            "b_in": r.stack(h + "mlp.fc_in.bias", L),
            "w_out": r.stack(h + "mlp.fc_out.weight", L, True),
            "b_out": r.stack(h + "mlp.fc_out.bias", L),
        },
    }
    ln_f = {"scale": r("transformer.ln_f.weight"),
            "bias": r("transformer.ln_f.bias")}
    return embed, blocks, ln_f


def convert_gptneox_state_dict(sd, spec: ModelSpec, dtype=torch.float32
                               ) -> Tuple[Params, Params, Params]:
    """GPT-NeoX: the fused qkv [3D, D] is interleaved per head ->
    de-interleaved and transposed; separate input / post-attention norms;
    an untied embed_out (zero bias)."""
    r = _Reader(sd, dtype)
    L, D, H, hd = spec.n_layer, spec.d_model, spec.n_head, spec.head_dim
    lay = "gpt_neox.layers.{i}."

    def split_qkv(i):
        # [3D, D] laid out as [H, 3, hd, D]; the bias as [H, 3, hd]
        w = r(lay.format(i=i) + "attention.query_key_value.weight")
        b = r(lay.format(i=i) + "attention.query_key_value.bias")
        w, b = w.reshape(H, 3, hd, D), b.reshape(H, 3, hd)
        return ([w[:, j].reshape(D, D).t() for j in range(3)],
                [b[:, j].reshape(D) for j in range(3)])

    parts = [split_qkv(i) for i in range(L)]
    ws = [torch.stack([p[0][j] for p in parts]) for j in range(3)]
    bs = [torch.stack([p[1][j] for p in parts]) for j in range(3)]
    embed = {
        "wte": r("gpt_neox.embed_in.weight"),
        "lm_head": {"w": r("embed_out.weight").t().contiguous(),
                    "b": r.zeros(spec.vocab_size, "embed_out.weight")},
    }
    blocks = {
        "ln_1": {"scale": r.stack(lay + "input_layernorm.weight", L),
                 "bias": r.stack(lay + "input_layernorm.bias", L)},
        "ln_2": {
            "scale": r.stack(lay + "post_attention_layernorm.weight", L),
            "bias": r.stack(lay + "post_attention_layernorm.bias", L),
        },
        "attn": {
            "wq": ws[0], "wk": ws[1], "wv": ws[2],
            "bq": bs[0], "bk": bs[1], "bv": bs[2],
            "wo": r.stack(lay + "attention.dense.weight", L, True),
            "bo": r.stack(lay + "attention.dense.bias", L),
        },
        "mlp": {
            "w_in": r.stack(lay + "mlp.dense_h_to_4h.weight", L, True),
            "b_in": r.stack(lay + "mlp.dense_h_to_4h.bias", L),
            "w_out": r.stack(lay + "mlp.dense_4h_to_h.weight", L, True),
            "b_out": r.stack(lay + "mlp.dense_4h_to_h.bias", L),
        },
    }
    ln_f = {"scale": r("gpt_neox.final_layer_norm.weight"),
            "bias": r("gpt_neox.final_layer_norm.bias")}
    return embed, blocks, ln_f


def convert_llama_state_dict(sd, spec: ModelSpec, dtype=torch.float32
                             ) -> Tuple[Params, Params, Params]:
    """LLaMA: RMSNorm (weight only), unbiased q/k/v/o projections (k/v in
    the compact GQA width), a SwiGLU mlp (gate/up/down), an untied
    lm_head unless tied. HF's llama rotates halves, the port's
    non-interleaved rotary path, so weights transpose straight across."""
    r = _Reader(sd, dtype)
    L = spec.n_layer
    lay = "model.layers.{i}."
    embed = {"wte": r("model.embed_tokens.weight")}
    if not spec.tie_lm_head:
        embed["lm_head"] = {"w": r("lm_head.weight").t().contiguous(),
                            "b": r.zeros(spec.vocab_size, "lm_head.weight")}
    blocks = {
        "ln_1": {"scale": r.stack(lay + "input_layernorm.weight", L)},
        "ln_2": {"scale": r.stack(lay + "post_attention_layernorm.weight",
                                  L)},
        "attn": {
            "wq": r.stack(lay + "self_attn.q_proj.weight", L, True),
            "wk": r.stack(lay + "self_attn.k_proj.weight", L, True),
            "wv": r.stack(lay + "self_attn.v_proj.weight", L, True),
            "wo": r.stack(lay + "self_attn.o_proj.weight", L, True),
        },
        "mlp": {
            "w_gate": r.stack(lay + "mlp.gate_proj.weight", L, True),
            "w_in": r.stack(lay + "mlp.up_proj.weight", L, True),
            "w_out": r.stack(lay + "mlp.down_proj.weight", L, True),
        },
    }
    ln_f = {"scale": r("model.norm.weight")}
    return embed, blocks, ln_f


_CONVERTERS = {
    "gpt2": convert_gpt2_state_dict,
    "gptj": convert_gptj_state_dict,
    "gptneox": convert_gptneox_state_dict,
    "llama": convert_llama_state_dict,
}


def convert_state_dict(sd, spec: ModelSpec, dtype=torch.float32
                       ) -> Tuple[Params, Params, Params]:
    """(embed, stacked blocks, ln_f) from a torch state_dict, on its
    device, in ``dtype`` (None: each tensor's own)."""
    return _CONVERTERS[spec.arch.lower()](sd, spec, dtype)


def load_trunk_from_hf(model_path: str,
                       local_files_only: Optional[bool] = None):
    """Load an HF causal-LM checkpoint (a local directory or a model the
    local cache holds) and return (spec, embed, blocks, ln_f), float32
    CPU tensors. Local files are tried first, so an offline machine fails
    fast instead of stalling on hub retries
    (trlx_tpu_torch.utils.hf_offline)."""
    from transformers import AutoConfig, AutoModelForCausalLM

    from trlx_tpu_torch.utils.hf_offline import local_first_attempts

    attempts = (
        [{"local_files_only": local_files_only}]
        if local_files_only is not None
        else list(local_first_attempts())
    )
    last_err = None
    for kw in attempts:
        try:
            hf_config = AutoConfig.from_pretrained(model_path, **kw)
            spec = spec_from_hf_config(hf_config)
            model = AutoModelForCausalLM.from_pretrained(model_path, **kw)
            embed, blocks, ln_f = convert_state_dict(model.state_dict(), spec)
            return spec, embed, blocks, ln_f
        except Exception as e:  # noqa: BLE001 - the last one is raised
            last_err = e
    raise last_err


def _first(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _heads(rng: np.random.Generator, d_in: int, d_out: int, like):
    """Fresh float32 head weights drawn with numpy, on ``like``'s
    device."""
    return tree_map(lambda x: torch.from_numpy(x).to(like.device),
                    init_head_params(rng, d_in, d_out))


def hydra_params_from_trunk(policy, embed: Params, blocks: Params,
                            ln_f: Params, rng: np.random.Generator,
                            frozen_dtype=None) -> Params:
    """The hydra tree from an imported trunk: the bottom blocks and the
    embeddings frozen (stored in ``frozen_dtype`` when given), the top
    ``k`` blocks and ln_f (and an untied lm_head) trainable as imported,
    the reference branch a copy of them (in ``frozen_dtype`` too), and a
    fresh value head from ``rng``. Leaves stay on the trunk's device; the
    bottom and top are views of the stacked blocks."""
    spec, k = policy.spec, policy.k
    L = spec.n_layer
    bottom = tree_map(lambda x: x[:L - k], blocks)
    top = tree_map(lambda x: x[L - k:], blocks)
    embed = dict(embed)
    lm_head = embed.pop("lm_head", None)  # trainable: stays as imported
    if frozen_dtype is not None:
        bottom = tree_map(lambda x: x.to(frozen_dtype), bottom)
        embed = tree_map(lambda x: x.to(frozen_dtype), embed)
    trainable: Params = {
        "blocks": top,
        "ln_f": ln_f,
        "v_head": _heads(rng, spec.d_model, 1, _first(ln_f)),
    }
    ref: Params = {"blocks": tree_map(torch.clone, top),
                   "ln_f": tree_map(torch.clone, ln_f)}
    if lm_head is not None:
        trainable["lm_head"] = lm_head
        ref["lm_head"] = tree_map(torch.clone, lm_head)
    if frozen_dtype is not None:
        # the reference branch is frozen too: the trunk's storage dtype
        ref = tree_map(lambda x: x.to(frozen_dtype), ref)
    return {
        "frozen_base": {"embed": embed, "blocks": bottom},
        "trainable": trainable,
        "ref": ref,
    }


def ilql_params_from_trunk(net, embed: Params, blocks: Params, ln_f: Params,
                           rng: np.random.Generator) -> Params:
    """The ILQL tree from an imported trunk: the bottom frozen, the top
    trainable, fresh V and Q heads from ``rng``, the target heads copies
    of the Q heads; at full unfreeze the embeddings move to ``trainable``
    (``split_embed_for_unfreeze``). Leaves stay on the trunk's device."""
    spec, k = net.spec, net.k
    L = spec.n_layer
    like = _first(ln_f)
    bottom = tree_map(lambda x: x[:L - k], blocks)
    top = tree_map(lambda x: x[L - k:], blocks)
    embed = dict(embed)
    lm_head = embed.pop("lm_head", None)
    q1 = _heads(rng, spec.d_model, spec.vocab_size, like)
    trainable: Params = {
        "blocks": top,
        "ln_f": ln_f,
        "v_head": _heads(rng, spec.d_model, 1, like),
        "q1_head": q1,
    }
    target: Params = {"q1_head": tree_map(torch.clone, q1)}
    if net.two_qs:
        q2 = _heads(rng, spec.d_model, spec.vocab_size, like)
        trainable["q2_head"] = q2
        target["q2_head"] = tree_map(torch.clone, q2)
    if lm_head is not None:
        trainable["lm_head"] = lm_head
    frozen_embed, train_embed = split_embed_for_unfreeze(embed, k, spec)
    if train_embed is not None:
        trainable["embed"] = train_embed
    return {
        "frozen_base": {"embed": frozen_embed, "blocks": bottom},
        "trainable": trainable,
        "target": target,
    }
