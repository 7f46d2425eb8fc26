"""Weights carried across: trlx_tpu param trees -> the port's trainer
tree and decode views.

The trainer holds the WHOLE hydra tree (frozen_base, trainable with its
value head, ref): :func:`hydra_to_torch` places a numpy tree (what
``jax.device_get`` returns, or :func:`init_hydra_numpy`'s seeded
random one) on a device, and :func:`hydra_to_numpy` brings (updated)
parameters back for comparison. The ILQL trainer's tree ({frozen_base,
trainable, target}) crosses the same way: :func:`init_ilql_numpy`,
:func:`ilql_to_torch`, :func:`ilql_to_numpy`; a reward model's tree
({embed, blocks, ln_f, r_head}) through :func:`reward_to_torch`.

The port serves from DECODE VIEWS: ``DecodeViews(blocks, embed, ln_f)``
where ``blocks`` is the (trunk, trainable-top) pair of stacked block
segments, ``embed`` holds wte (+ wpe, + lm_head when untied) and
``ln_f`` the final norm — the same split trlx_tpu's engine strips a
hydra tree to (``policy.py:261-282``), leaf for leaf.

- :func:`decode_views_from_numpy` maps a trlx_tpu hydra tree given as
  nested dicts of numpy arrays (what ``jax.device_get`` returns);
- :func:`init_decode_views` makes a numpy-seeded random policy in the
  same structure (for card runs, where no JAX exists);
- :func:`views_to` places views on a device for serving;
- :func:`save_decode_views` / :func:`load_decode_views` are the
  ``torch.save`` file the serve CLI's ``--weights`` reads.
"""

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.heads import init_head_params
from trlx_tpu_torch.models.ilql import split_embed_for_unfreeze
from trlx_tpu_torch.models.policy import (
    all_blocks,
    head_params_for_decode,
    resolve_num_unfrozen,
)
from trlx_tpu_torch.models.transformer import ArchFlags, num_layers, tree_map

Params = Dict[str, Any]

#: norm subtrees keep their own (float32) dtype at any compute dtype —
#: layer_norm reads them in float32, so casting them would change numerics
_NORM_KEYS = ("ln_1", "ln_2")


class DecodeViews(NamedTuple):
    blocks: Tuple[Params, Params]  # (trunk, trainable top) stacked segments
    embed: Params
    ln_f: Params


def _to_torch(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach()
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def decode_views_from_numpy(hydra_tree: Params, spec: ModelSpec,
                            num_layers_unfrozen: int) -> DecodeViews:
    """A hydra param tree (nested dicts of numpy arrays, as trlx_tpu's
    comes back, or of torch tensors, as the port's trainer and its
    checkpoints hold it) -> torch decode views: numpy leaves copied to
    the CPU, torch leaves detached where they are, not copied (a
    trainer's card-resident tree serves without a round trip through the
    host; :func:`views_to` makes the engine's own copies where the dtype
    or device differs). Checks the trunk/top split against
    ``num_layers_unfrozen``."""
    bottom, top = all_blocks(hydra_tree)
    embed, ln_f = head_params_for_decode(hydra_tree)
    k = resolve_num_unfrozen(spec, num_layers_unfrozen)
    n_bottom, n_top = num_layers(bottom), num_layers(top)
    if n_top != k or n_bottom + n_top != spec.n_layer:
        raise ValueError(
            f"param tree splits {n_bottom} + {n_top} layers but the spec "
            f"has {spec.n_layer} with num_layers_unfrozen="
            f"{num_layers_unfrozen}"
        )
    return DecodeViews(
        blocks=(tree_map(_to_torch, bottom), tree_map(_to_torch, top)),
        embed=tree_map(_to_torch, embed),
        ln_f=tree_map(_to_torch, ln_f),
    )


def _init_base_numpy(spec: ModelSpec, rng: np.random.Generator):
    """(embed, stacked blocks [L, ...], ln_f) with trlx_tpu's init scheme:
    N(0, 0.02) matrices, residual projections scaled by
    1/sqrt(2 * n_layer), zero biases, unit norm scales; float32, drawn
    from ``rng`` in a fixed order."""
    flags = ArchFlags.for_spec(spec)
    L, d, f, V = spec.n_layer, spec.d_model, spec.d_ff, spec.vocab_size
    d_kv = spec.kv_heads * spec.head_dim
    resid = 0.02 / max(2 * L, 1) ** 0.5

    def normal(shape, scale=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def norm():
        p = {"scale": np.ones((L, d), np.float32)}
        if not flags.rmsnorm:
            p["bias"] = zeros(L, d)
        return p

    blocks = {
        "ln_1": norm(),
        "attn": {
            "wq": normal((L, d, d)), "wk": normal((L, d, d_kv)),
            "wv": normal((L, d, d_kv)), "wo": normal((L, d, d), resid),
        },
        "mlp": {"w_in": normal((L, d, f)), "w_out": normal((L, f, d), resid)},
    }
    if flags.swiglu:
        blocks["mlp"]["w_gate"] = normal((L, d, f))
    else:
        blocks["mlp"]["b_in"] = zeros(L, f)
        blocks["mlp"]["b_out"] = zeros(L, d)
    if flags.attn_bias:
        blocks["attn"].update(bq=zeros(L, d), bk=zeros(L, d_kv),
                              bv=zeros(L, d_kv), bo=zeros(L, d))
    if flags.separate_mlp_ln:
        blocks["ln_2"] = norm()
    embed = {"wte": normal((V, d))}
    if not flags.use_rotary:
        embed["wpe"] = normal((spec.n_positions, d), 0.01)
    ln_f = {"scale": np.ones((d,), np.float32)}
    if not flags.rmsnorm:
        ln_f["bias"] = zeros(d)
    return embed, blocks, ln_f


def _untied_lm_head(spec: ModelSpec, rng: np.random.Generator) -> Params:
    d, V = spec.d_model, spec.vocab_size
    return {"w": rng.standard_normal((d, V), dtype=np.float32) * 0.02,
            "b": np.zeros((V,), np.float32)}


def init_hydra_numpy(spec: ModelSpec, num_layers_unfrozen: int = -1,
                     seed: int = 0) -> Params:
    """A random hydra tree — frozen_base, trainable (with its value head)
    and the reference branch, an exact copy of the trainable transformer
    part — with trlx_tpu's init scheme (:func:`_init_base_numpy`, a
    uniform-init value head), drawn from a numpy generator seeded with
    ``seed``. float32 throughout."""
    rng = np.random.default_rng(seed)
    embed, blocks, ln_f = _init_base_numpy(spec, rng)
    L = spec.n_layer
    k = resolve_num_unfrozen(spec, num_layers_unfrozen)
    trainable = {
        "blocks": tree_map(lambda x: x[L - k:], blocks), "ln_f": ln_f,
    }
    if not spec.tie_lm_head:
        trainable["lm_head"] = _untied_lm_head(spec, rng)
    trainable["v_head"] = init_head_params(rng, spec.d_model, 1)
    ref = {key: tree_map(np.copy, trainable[key])
           for key in ("blocks", "ln_f", "lm_head") if key in trainable}
    return {
        "frozen_base": {"embed": embed,
                        "blocks": tree_map(lambda x: x[:L - k], blocks)},
        "trainable": trainable,
        "ref": ref,
    }


def init_ilql_numpy(spec: ModelSpec, num_layers_unfrozen: int = -1,
                    two_qs: bool = True, seed: int = 0) -> Params:
    """A random ILQL tree in trlx_tpu's structure (``{frozen_base,
    trainable, target}``, see trlx_tpu_torch.models.ilql): the trunk as
    :func:`init_hydra_numpy` draws it, a uniform-init value head and Q
    heads, the target heads exact copies of the Q heads. At full
    unfreeze the embeddings sit in ``trainable`` and the frozen bottom
    has zero-size [0, ...] leaves. float32 throughout."""
    rng = np.random.default_rng(seed)
    embed, blocks, ln_f = _init_base_numpy(spec, rng)
    L, d, V = spec.n_layer, spec.d_model, spec.vocab_size
    k = resolve_num_unfrozen(spec, num_layers_unfrozen)
    trainable = {
        "blocks": tree_map(lambda x: x[L - k:], blocks), "ln_f": ln_f,
        "v_head": init_head_params(rng, d, 1),
        "q1_head": init_head_params(rng, d, V),
    }
    names = ("q1_head", "q2_head") if two_qs else ("q1_head",)
    if two_qs:
        trainable["q2_head"] = init_head_params(rng, d, V)
    if not spec.tie_lm_head:
        trainable["lm_head"] = _untied_lm_head(spec, rng)
    frozen_embed, train_embed = split_embed_for_unfreeze(embed, k, spec)
    if train_embed is not None:
        trainable["embed"] = train_embed
    return {
        "frozen_base": {"embed": frozen_embed,
                        "blocks": tree_map(lambda x: x[:L - k], blocks)},
        "trainable": trainable,
        "target": {n: tree_map(np.copy, trainable[n]) for n in names},
    }


def _place(x, device, dtype) -> torch.Tensor:
    """A numpy leaf as a fresh torch tensor on ``device``, floating
    leaves in ``dtype``; a torch leaf already on ``device`` in that dtype
    is taken over as it is (detached, not copied: a 6B tree built on the
    card is not duplicated there), any other one copied."""
    t = x.detach() if torch.is_tensor(x) else \
        torch.as_tensor(np.array(x, copy=True, order="C"))
    return t.to(device=device, dtype=dtype if t.is_floating_point()
                else t.dtype)


def _on_mesh(tree: Params, mesh) -> Params:
    """``tree`` placed on ``mesh`` by trlx_tpu's leaf rules
    (trlx_tpu_torch.parallel ``param_placements``); None: as it is."""
    if mesh is None:
        return tree
    from trlx_tpu_torch.parallel import shard_params

    return shard_params(mesh, tree)


def hydra_to_torch(tree: Params, device=None,
                   frozen_dtype=torch.float32, mesh=None) -> Params:
    """A hydra tree of numpy (or torch) leaves as torch tensors on
    ``device``: ``frozen_base`` and ``ref`` stored in ``frozen_dtype``
    (every leaf, as trlx_tpu casts them), ``trainable`` float32 leaves
    that require grad — the trainer's parameter tree. Torch leaves
    already on ``device`` in their target dtype are taken over, not
    copied (:func:`_place`). With a ``mesh`` every leaf becomes a
    DTensor on its placements."""

    def frozen(sub):
        return tree_map(lambda x: _place(x, device, frozen_dtype), sub)

    trainable = tree_map(
        lambda x: _place(x, device, torch.float32).requires_grad_(True),
        tree["trainable"],
    )
    return _on_mesh({"frozen_base": frozen(tree["frozen_base"]),
                     "trainable": trainable, "ref": frozen(tree["ref"])},
                    mesh)


def ilql_to_torch(tree: Params, device=None, mesh=None) -> Params:
    """An ILQL tree of numpy (or torch) leaves as float32 torch tensors on
    ``device``, as trlx_tpu stores every ILQL leaf: ``trainable`` leaves
    require grad, ``frozen_base`` and ``target`` do not. Zero-size leaves
    and an empty frozen embed carry over as they are. With a ``mesh``
    every leaf becomes a DTensor on its placements."""
    frozen = {key: tree_map(lambda x: _place(x, device, torch.float32),
                            tree[key]) for key in ("frozen_base", "target")}
    trainable = tree_map(
        lambda x: _place(x, device, torch.float32).requires_grad_(True),
        tree["trainable"])
    return _on_mesh({"frozen_base": frozen["frozen_base"],
                     "trainable": trainable, "target": frozen["target"]},
                    mesh)


def reward_to_torch(tree: Params, device=None, mesh=None) -> Params:
    """A reward-model tree ({embed, blocks, ln_f, r_head}) of numpy or
    torch leaves as FRESH torch tensors on ``device``, each leaf keeping
    its dtype and leaving any autograd graph behind: a copy that the
    tensors it came from (a trainer's, updated in place) never touch. A
    DTensor leaf is copied whole; with a ``mesh`` every leaf becomes a
    DTensor on its placements."""
    from trlx_tpu_torch.parallel.sharding import whole

    return _on_mesh(tree_map(
        lambda x: whole(x).detach().to(device=device, copy=True)
        if torch.is_tensor(x)
        else torch.as_tensor(np.array(x, copy=True, order="C")).to(device),
        tree), mesh)


def hydra_to_numpy(tree: Params) -> Params:
    """torch -> numpy for a (sub)tree, float32 for floating leaves; a
    DTensor leaf is gathered whole (every process must call this)."""
    from trlx_tpu_torch.parallel.sharding import whole

    def to_numpy(x):
        x = whole(x).detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()

    return tree_map(to_numpy, tree)


#: an ILQL tree comes back to numpy the same way
ilql_to_numpy = hydra_to_numpy


def init_decode_views(spec: ModelSpec, seed: int = 0,
                      num_layers_unfrozen: int = -1) -> DecodeViews:
    """Seeded random decode views (CPU, float32)."""
    return decode_views_from_numpy(
        init_hydra_numpy(spec, num_layers_unfrozen, seed), spec,
        num_layers_unfrozen,
    )


def views_to(views: DecodeViews, device, compute_dtype) -> DecodeViews:
    """Views on ``device`` for serving: matmul weights, biases and
    embeddings stored in ``compute_dtype`` (every use casts them to it
    anyway, so pre-casting changes no result and halves bf16 memory);
    norm parameters keep float32, and an int8 weight's (codes, scale)
    pair (trlx_tpu_torch.serve.engine ``quantize_serve_weights``) keeps
    its int8 codes and float32 scales."""

    def place(tree, keep):
        if isinstance(tree, dict):
            return {k: place(v, keep or k in _NORM_KEYS)
                    for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(x.to(device=device) for x in tree)
        dtype = tree.dtype if keep or not tree.is_floating_point() \
            else compute_dtype
        return tree.to(device=device, dtype=dtype)

    return DecodeViews(
        blocks=tuple(place(seg, False) for seg in views.blocks),
        embed=place(views.embed, False),
        ln_f=place(views.ln_f, True),
    )


def save_decode_views(views: DecodeViews, path: str) -> None:
    torch.save({"blocks": list(views.blocks), "embed": views.embed,
                "ln_f": views.ln_f}, path)


def load_decode_views(path: str) -> DecodeViews:
    data = torch.load(path, map_location="cpu", weights_only=True)
    return DecodeViews(tuple(data["blocks"]), data["embed"], data["ln_f"])
