"""Decode-time placements: the serving stack's own at-rest layouts (port of
trlx_tpu.serve.layouts).

Training shards for gradient math (trlx_tpu_torch.parallel.sharding);
decode has a different steady state — a batch of single-token matvecs
against resident weights and a paged KV pool — so serve/ carries its own
rule set, trlx_tpu's leaf for leaf:

- **Weights** follow Megatron tensor parallelism over ``tp``: the
  in-projections (wq/wk/wv, w_in/w_gate) are column-parallel, the
  out-projections (wo, w_out) row-parallel, so every block costs one sum
  over the tp group per sublayer and attention heads split across
  processes. The second big dim either shards over ``fsdp``
  (``serve.mesh_weights: fsdp``, gathered on use in the step) or stays
  whole (``"replicated"``: no gathers on the decode path).
- **KV pages** shard on the *head* dim (axis 3 of ``[L, pages,
  page_size, Hkv, hd]``) under ``tp``, the split of the attention
  projections, so the step's attention needs no KV collective. The page
  tables stay host int32 data, the same on every process: the radix
  cache, allocator and replay logic know nothing of the mesh.
- **Slot lanes** (valid / offset / logits / pages) are the same on
  every process.

Where trlx_tpu's single controller lets GSPMD place arrays on devices,
here each process of a ``torchrun`` world holds plain tensors: its own
slices of every leaf (:func:`local_slice`), cut by the fitted spec of
the leaf. :class:`DecodeParallel` is what the decode step runs them
with: Megatron's two operators over the tp group, the gathers on use
over fsdp, and the vocabulary split of the embedding and the logits.

Non-dividing dims (gpt2's odd vocabulary, Hkv < tp) fall back to
replication per axis through the fit rule of training
(``sharding._fit_spec_to_shape``): correct, just less sharded.
"""

from typing import Any, Dict, Optional, Tuple

import torch

from trlx_tpu_torch.parallel.mesh import AXES, mesh_sizes
from trlx_tpu_torch.parallel.sharding import (
    P,
    TensorParallel,
    _fit_spec_to_shape,
    _map_with_path,
)

#: mesh axes serving understands; dp/pp/sp belong to training (serve's
#: data parallelism is replica processes, not an axis)
SERVE_AXES = ("tp", "fsdp")

#: KV pool spec — paged [L, pages, page_size, Hkv, hd] and contiguous
#: [L, slots, buffer_len, Hkv, hd] both carry heads on axis 3
KV_POOL_SPEC = P(None, None, None, "tp", None)

#: leaf names of the attention sublayer (its column and row shards)
_ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _world_size() -> int:
    """The processes the serve mesh would span: the process group's
    world, or torchrun's ``WORLD_SIZE`` before it is joined."""
    import os

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def serve_axis_sizes(mesh_config: Dict[str, int]) -> Dict[str, int]:
    """``serve.mesh`` validated: {tp, fsdp} sizes, trlx_tpu's refusals and
    messages (no process group needed)."""
    unknown = set(mesh_config) - set(SERVE_AXES)
    if unknown:
        raise ValueError(
            f"serve.mesh axes {sorted(unknown)} are not serveable; the "
            f"decode mesh takes {SERVE_AXES} only (dp/pp/sp are training "
            f"axes — serve replicas scale horizontally instead)"
        )
    sizes = {ax: int(mesh_config.get(ax, 1)) for ax in SERVE_AXES}
    bad = {ax: v for ax, v in sizes.items() if v < 1}
    if bad:
        raise ValueError(
            f"serve.mesh axis sizes must be >= 1, got {bad} (wildcards "
            f"don't apply: a serve slice is sized explicitly)"
        )
    return sizes


def build_serve_mesh(mesh_config: Optional[Dict[str, int]],
                     device_type: str = "cuda"):
    """The serve mesh from ``serve.mesh`` ({axis: size} over tp/fsdp), a
    DeviceMesh with dp, pp and sp at 1, or None when ``serve.mesh`` is
    unset or empty (the single-process path, no process group).

    The mesh is the world: one process per card, as ``torchrun
    --nproc_per_node tp*fsdp`` starts them (a world of one when nothing
    started it). A world of another size is refused here, before any
    process group is joined. The process group's backend, when one
    exists, decides the collectives' transport (NCCL for ``cuda``, gloo
    for ``cpu``), else ``device_type`` does."""
    if not mesh_config:
        return None
    sizes = serve_axis_sizes(mesh_config)
    need = sizes["tp"] * sizes["fsdp"]
    avail = _world_size()
    if need > avail:
        raise ValueError(
            f"serve.mesh {dict(mesh_config)} needs {need} devices but "
            f"only {avail} are visible"
        )
    if need < avail:
        raise ValueError(
            f"serve.mesh {dict(mesh_config)} spans {need} processes but "
            f"the world has {avail}: the serve mesh is the whole world, "
            f"so start tp x fsdp processes (torchrun --nproc_per_node "
            f"{need})"
        )
    import torch.distributed as dist

    from trlx_tpu_torch.parallel.mesh import build_mesh

    if dist.is_available() and dist.is_initialized():
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return build_mesh({"fsdp": sizes["fsdp"], "tp": sizes["tp"]},
                      device_type)


def decode_spec_for_leaf(path_names: Tuple[str, ...], ndim: int,
                         weights: str = "fsdp") -> P:
    """The spec of one decode-view leaf, by key path and rank.

    ``weights`` picks the second-axis treatment of the big matrices:
    ``"fsdp"`` shards it (capacity), ``"replicated"`` keeps it whole (no
    gather on the matvec path). The tp split is always on."""
    W = "fsdp" if weights == "fsdp" else None
    # int8 serve weights are (codes, scale) pairs: the key path ends in a
    # sequence index, so digits are stripped for the rules to match both
    # members (the scale's [L, 1, out] dims fall back per axis in the fit)
    path_names = tuple(n for n in path_names if not n.isdigit())
    name = path_names[-1] if path_names else ""
    parent = path_names[-2] if len(path_names) > 1 else ""

    # stacked per-layer matrices [L, in, out]: the layer axis never shards
    if ndim == 3:
        if name in ("wq", "wk", "wv", "w_in", "w_gate"):
            return P(None, W, "tp")  # column-parallel
        if name in ("wo", "w_out"):
            return P(None, "tp", W)  # row-parallel (summed after)
    if ndim == 2:
        if name in ("bq", "bk", "bv", "b_in"):
            return P(None, "tp")  # live on the tp-sharded output dim
        if name in ("bo", "b_out"):
            return P(None, None)  # added after the sum
    if name == "wte":  # [V, D]: gathered by token id, then the tied head
        return P("tp", W)
    if name == "wpe":  # [N_pos, D]
        return P(None, W)
    if parent == "lm_head":
        if name == "w" and ndim == 2:  # [D, V]
            return P(W, "tp")
        if name == "b" and ndim == 1:
            return P("tp")
    # layernorms, scalars, anything unmatched: replicated
    return P()


def decode_specs(views, sizes: Dict[str, int], weights: str = "fsdp"):
    """The fitted spec tree of decode views (``(blocks, embed, ln_f)`` or
    any tree of tensors or shapes with ``.shape``): non-dividing dims fall
    back per axis."""
    def leaf(path, x):
        shape = tuple(x.shape)
        return _fit_spec_to_shape(decode_spec_for_leaf(path, len(shape),
                                                       weights),
                                  shape, sizes)

    return _map_with_path(leaf, _plain(views))


def kv_pool_spec(shape, sizes: Dict[str, int]) -> P:
    """The fitted spec of one KV pool leaf: heads (axis 3) over tp for the
    5-d K/V pages (paged or contiguous) and the int8 tier's 4-d scale
    planes, everything else replicated; an Hkv that tp does not divide
    replicates."""
    nd = len(shape)
    if nd == 5:
        spec = KV_POOL_SPEC
    elif nd == 4:
        spec = P(None, None, None, "tp")
    else:
        spec = P()
    return _fit_spec_to_shape(spec, tuple(shape), sizes)


def _plain(tree):
    """Named tuples (DecodeViews) as plain tuples, so the path maps can
    rebuild them."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_plain(v) for v in tree)
    return tree


def _coords(mesh) -> Dict[str, int]:
    coord = mesh.get_coordinate()
    return {ax: int(coord[i]) for i, ax in enumerate(AXES)}


def local_slice(x: torch.Tensor, spec: P, sizes: Dict[str, int],
                coords: Dict[str, int]) -> torch.Tensor:
    """This process's slice of the whole tensor ``x`` under ``spec`` (a
    view: each sharded dim cut to the chunk of this process's coordinate
    on the dim's axis)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = sizes[ax]
        if n == 1:
            continue
        chunk = x.shape[d] // n
        x = x.narrow(d, coords[ax] * chunk, chunk)
    return x


def shard_views(mesh, views, weights: str = "fsdp"):
    """(blocks, embed, ln_f) cut to this process's slices (views of the
    whole tensors; the caller places them)."""
    sizes, coords = mesh_sizes(mesh), _coords(mesh)
    specs = decode_specs(views, sizes, weights)
    return _zip_specs(
        lambda x, s: local_slice(x, s, sizes, coords).clone(
            memory_format=torch.contiguous_format),
        _plain(views), specs)


def decode_slicer(mesh, weights: str = "fsdp"):
    """``slicer(path, x)`` for trlx_tpu_torch.utils.checkpoint
    ``slice_tree``: this process's slice of a hydra-tree leaf (its decode
    placement, by name and rank, as trlx_tpu's sharded restore places the
    restore template)."""
    sizes, coords = mesh_sizes(mesh), _coords(mesh)

    def slicer(path, x):
        shape = tuple(x.shape)
        spec = _fit_spec_to_shape(
            decode_spec_for_leaf(path, len(shape), weights), shape, sizes)
        return local_slice(x, spec, sizes, coords)

    return slicer


def _zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def tree_bytes_per_device(tree: Any) -> int:
    """Resident bytes of this process's tensors in ``tree``: each leaf is
    already its local shard, so a tp-2-sharded matrix counts half."""
    total = 0

    def add(x):
        nonlocal total
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()

    _map_with_path(lambda _, x: add(x), _plain(tree))
    return total


def mesh_info(mesh, weights: str = "fsdp") -> Dict[str, Any]:
    """The /healthz- and /debug/state-facing description of the serve
    mesh: axis names and sizes (non-trivial axes only), device count and
    the weights-placement knob."""
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    axes = {ax: int(sizes[ax]) for ax in SERVE_AXES[::-1]
            if sizes.get(ax, 1) > 1}
    devices = 1
    for ax in SERVE_AXES:
        devices *= int(sizes.get(ax, 1))
    return {"devices": devices, "axes": axes or {"tp": 1},
            "weights": weights}


# -- compute on the serve mesh ----------------------------------------------


def _gather_plan(specs, tp_attn: bool):
    """Per leaf (stacked dims), the (dim, axis) pairs gathered on use: every
    fsdp-sharded dim, and the tp-sharded dims of the attention leaves when
    the attention runs whole width (tp not dividing the heads)."""
    def leaf(path, spec):
        name = next((n for n in reversed(path) if not n.isdigit()), "")
        out = []
        for d, ax in enumerate(spec):
            if ax == "fsdp" or (ax == "tp" and not tp_attn
                                and name in _ATTN_LEAVES):
                out.append((d, ax))
        return tuple(out)

    return _map_with_path(leaf, specs)


class DecodeParallel(TensorParallel):
    """The decode step's operators on the serve mesh: Megatron's
    ``enter`` / ``reduce`` over the tp group (trlx_tpu_torch.models.
    transformer ``block_apply``; under ``no_grad`` they are the identity
    and the sum), the gathers on use of the leaves sharded over fsdp
    (:meth:`layer`, :meth:`head`), and the vocabulary split of the
    embedding and the logits (:meth:`embed_rows`, :meth:`whole_vocab`).

    ``attn`` / ``mlp`` say whether each sublayer runs on this process's
    shard (tp divides the heads and the KV heads; the MLP width) or
    whole width. The collectives run whatever the sizes, so a world of
    one runs the code path of a larger one."""

    def __init__(self, mesh, spec, views, weights: str = "fsdp"):
        """``views``: the whole (blocks, embed, ln_f) as served (int8 pairs
        included), any leaves with shapes (meta tensors will do)."""
        super().__init__(mesh)
        sizes = mesh_sizes(mesh)
        self.sizes = sizes
        self.coords = _coords(mesh)
        self.fsdp_group = mesh.get_group(AXES.index("fsdp"))
        self.groups = {"tp": self.group, "fsdp": self.fsdp_group}
        tp = sizes["tp"]
        # the attention splits where the KV pool's heads do (tp then
        # divides the query heads too: Hkv divides H)
        pool = (1, 1, 1, spec.kv_heads, spec.head_dim)
        self.attn = kv_pool_spec(pool, sizes)[3] == "tp"
        self.mlp = spec.d_ff % tp == 0
        self.weights = weights
        blocks, embed, ln_f = _plain(views)
        specs = decode_specs((blocks, embed, ln_f), sizes, weights)
        #: the fitted specs of the block segments (int8 pairs included)
        self.block_specs = specs[0]
        #: per block segment / for the head leaves: what gathers on use
        self.block_plans = [_gather_plan(s, self.attn) for s in specs[0]]
        self.head_plan = _gather_plan((specs[1], specs[2]), self.attn)
        self.vocab = spec.vocab_size
        #: the vocabulary splits over tp iff tp divides it (the fit rule)
        self.vocab_split = tp > 1 and spec.vocab_size % tp == 0

    def kv_heads(self, spec) -> int:
        """The KV heads this process's pool holds."""
        return spec.kv_heads // self.size if self.attn else spec.kv_heads

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The whole of ``x`` along ``dim`` from the shards of ``axis``'s
        group (an all-gather, in group-rank order)."""
        import torch.distributed as dist

        n = self.sizes[axis]
        if n == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, src, group=self.groups[axis])
        return out.movedim(0, dim)

    def _apply_plan(self, tree, plan, shift: int):
        if isinstance(tree, dict):
            return {k: self._apply_plan(v, plan[k], shift)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._apply_plan(v, p, shift)
                              for v, p in zip(tree, plan))
        for d, ax in plan:
            tree = self.gather(tree, d - shift, ax)
        return tree

    def layer(self, segment: int, p_layer):
        """Layer params (one layer of block segment ``segment``) with the
        leaves sharded over fsdp gathered whole (and, when the attention
        runs whole width, its tp shards)."""
        return self._apply_plan(p_layer, self.block_plans[segment], 1)

    def head(self, embed, ln_f):
        """(embed, ln_f) with their fsdp shards gathered whole."""
        return self._apply_plan((embed, ln_f), self.head_plan, 0)

    def embed_rows(self, wte: torch.Tensor, ids: torch.Tensor
                   ) -> torch.Tensor:
        """Embedding rows of ``ids`` (clamped into the vocabulary) from this
        process's vocabulary shard: a masked lookup, summed over tp (each
        id's row lives on one process)."""
        ids = ids.long().clamp(0, self.vocab - 1)
        if not self.vocab_split:
            return wte[ids]
        n = wte.shape[0]
        lo = self.coords["tp"] * n
        local = ids - lo
        inside = (local >= 0) & (local < n)
        rows = wte[local.clamp(0, n - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return self.reduce(rows)

    def whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary from this process's shard
        (the last dim), the same on every process."""
        if not self.vocab_split:
            return logits
        return self.gather(logits, logits.dim() - 1, "tp")

    def all_reduce_max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise max of ``x`` over ``axis``'s group, in place."""
        import torch.distributed as dist

        if self.sizes[axis] > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.groups[axis])
        return x
