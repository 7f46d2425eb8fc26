"""Placements for the framework's parameter trees and data batches (port
of trlx_tpu.parallel.sharding).

The parameter trees stack per-layer tensors on a leading layer axis, so
a leaf's placement follows from its *name* and rank, one rule set for
every model family (trlx_tpu's rules, leaf for leaf):

- Megatron-style storage over ``tp``: in-projections (wq/wk/wv, mlp
  w_in, head w1) column-parallel (output dim sharded), out-projections
  (wo, mlp w_out, head w2) row-parallel (input dim sharded);
- ZeRO-3 storage over ``fsdp``: the other big dim of each matrix;
- an axis that does not divide a dim leaves that dim replicated (a
  50257- or 257-token vocabulary on ``tp``): DTensor would shard it
  unevenly, and the layout must stay trlx_tpu's.

A spec here is trlx_tpu's PartitionSpec as a tuple (one entry per
tensor dim: None, an axis name, or a tuple of them);
:func:`param_placements` turns it into one DTensor placement per mesh
dim (``Shard(d)`` or ``Replicate()``), a pure function of leaf path,
shape and axis sizes that needs no process group.

How the trainers compute on it (the port's counterpart of GSPMD): each
process runs the forward on ITS rows of the batch (:func:`local_rows`;
rows shard over (dp, fsdp) jointly, dp outermost), with every parameter
gathered on use (:func:`unshard`, an all-gather whose backward sums the
rows' partial gradients over (dp, fsdp) and hands each process its own
shard: an all-reduce over dp, a reduce-scatter over fsdp, a slice over
tp). Per-row results meet again in the global batch through
:func:`gather_rows` (an all-gather whose backward takes the process's
own rows back), so every loss and statistic is the single-process one.

Over sp each process of an sp group runs its chunk of the rows'
positions (trlx_tpu_torch.ops.ring_attention), so a parameter's
gradient is also a partial sum over sp (:func:`unshard`); over pp the
frozen trunk's stages keep their slab of layers (``keep_pp``) and the
trainable top runs alike on every stage, its gradient replicated. Rows
shard over (dp, fsdp) only: sp and pp processes hold the same rows.

Over tp the blocks run Megatron's compute (:class:`TensorParallel`):
their tp-ruled leaves are gathered over every other axis only, each
process keeping its column or row shard, so it computes its heads and
its part of the MLP width, and the row-parallel products are summed
over the tp group. Where tp does not split a model evenly
(:func:`tensor_parallel` is None), each tp process runs the whole width
and the flash kernels alone split the heads
(trlx_tpu_torch.ops.flash_attention).
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.parallel.mesh import AXES, mesh_sizes

Params = Dict[str, Any]


class P(tuple):
    """A spec: one entry per tensor dim (None, an axis name, or a tuple of
    axis names), trlx_tpu's ``PartitionSpec`` as a tuple. A leaf, not a
    container, to the tree maps here."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


# (leaf name, rank) -> spec. Rank-3 entries are stacked per-layer tensors
# [L, in, out]; the layer axis is never sharded.
_MATRIX_RULES = {
    # attention projections [L, D, D]
    "wq": P(None, "fsdp", "tp"),
    "wk": P(None, "fsdp", "tp"),
    "wv": P(None, "fsdp", "tp"),
    "wo": P(None, "tp", "fsdp"),
    # mlp [L, D, F] / [L, F, D]
    "w_in": P(None, "fsdp", "tp"),
    "w_gate": P(None, "fsdp", "tp"),  # llama swiglu gate, column-parallel
    "w_out": P(None, "tp", "fsdp"),
}

_VECTOR_RULES = {
    # column-parallel biases live on the tp-sharded output dim
    "bq": P(None, "tp"),
    "bk": P(None, "tp"),
    "bv": P(None, "tp"),
    "b_in": P(None, "tp"),
    # row-parallel biases are added after the sum — replicated
    "bo": P(None, None),
    "b_out": P(None, None),
}


def spec_for_leaf(path_names: Tuple[str, ...], ndim: int) -> P:
    """The spec of one leaf, by its key path and rank."""
    name = path_names[-1] if path_names else ""
    parent = path_names[-2] if len(path_names) > 1 else ""

    if name in _MATRIX_RULES and ndim == 3:
        return _MATRIX_RULES[name]
    if name in _VECTOR_RULES and ndim == 2:
        return _VECTOR_RULES[name]

    # embeddings
    if name == "wte":  # [V, D] — the largest single matrix
        return P("tp", "fsdp")
    if name == "wpe":  # [N_pos, D]
        return P(None, "fsdp")

    # untied lm head {w: [D, V], b: [V]}
    if parent == "lm_head":
        if name == "w" and ndim == 2:
            return P("fsdp", "tp")
        if name == "b" and ndim == 1:
            return P("tp")

    # MLP heads (value / Q): w1 [D, 2D] column-parallel, w2 [2D, out]
    # row-parallel (out is 1 for V, vocab for Q)
    if parent.endswith("_head"):
        if name == "w1" and ndim == 2:
            return P("fsdp", "tp")
        if name == "b1" and ndim == 1:
            return P("tp")
        if name == "w2" and ndim == 2:
            return P("tp", None)
        if name == "b2" and ndim == 1:
            return P(None)

    # layernorms, scalars, anything unmatched: replicated
    return P()


def _fit_spec_to_shape(spec: P, shape, sizes: Dict[str, int]) -> P:
    """Drop mesh axes from dims they don't divide evenly: an odd
    vocabulary (50257, 257) or a narrow head output stays replicated on
    that dim — correct, just less sharded."""
    dims = []
    for i, entry in enumerate(spec):
        if entry is None:
            dims.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for ax in axes:
            size *= sizes[ax]
        dims.append(entry if shape[i] % size == 0 else None)
    return P(*dims)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def zip_map(fn, tree, other):
    """``fn(leaf, other's entry at the leaf's place)`` over ``tree``'s
    structure (nested dicts / lists / tuples); ``other`` may hold
    anything at those places (a placement list, a tensor)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def param_sharding_specs(params: Params,
                         sizes: Optional[Dict[str, int]] = None) -> Params:
    """The spec tree matching ``params``' structure. With axis ``sizes``
    the specs are fitted to the leaf shapes (non-dividing dims fall back
    to replication)."""

    def leaf_spec(names, x):
        ndim = len(getattr(x, "shape", ()))
        spec = spec_for_leaf(names, ndim)
        # frozen-trunk blocks under a pipelined mesh: the stacked layer
        # axis shards over pp (trlx_tpu's layout: each stage holds its
        # slab, trlx_tpu_torch.ops.pipeline_parallel)
        if (sizes is not None and sizes.get("pp", 1) > 1
                and "frozen_base" in names and "blocks" in names
                and ndim >= 1):
            entries = list(spec) + [None] * (ndim - len(spec))
            entries[0] = "pp"
            spec = P(*entries)
        if sizes is not None:
            spec = _fit_spec_to_shape(spec, tuple(x.shape), sizes)
        return spec

    return _map_with_path(leaf_spec, params)


def spec_to_placements(spec: P) -> list:
    """One placement per mesh dim (:data:`AXES` order) for a spec: the
    tensor dim an axis names is ``Shard`` on that axis (several axes on
    one dim shard it in mesh order, outermost first), every other mesh
    dim ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in AXES]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[AXES.index(ax)] = Shard(d)
    return out


def param_placements(tree: Params, sizes: Dict[str, int]) -> Params:
    """The placement tree of a parameter tree under axis ``sizes``: per
    leaf, one placement per mesh dim. A pure function of leaf path,
    shape and sizes (no process group)."""
    return _map_with_path(lambda _, s: spec_to_placements(s),
                          param_sharding_specs(tree, sizes))


def param_shardings(mesh, params: Params) -> Params:
    """The placement tree of ``params`` on ``mesh``."""
    return param_placements(params, mesh_sizes(mesh))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _distribute(x: torch.Tensor, mesh, placements):
    """``x`` (the same global tensor on every process) as a DTensor, each
    process keeping its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def shard_params(mesh, params: Params) -> Params:
    """Place ``params`` (plain tensors, the same on every process) on the
    mesh under the framework's placements; a leaf that requires grad
    stays a leaf that requires grad."""
    def place(x, placements):
        if is_dtensor(x):
            return x
        d = _distribute(x.detach(), mesh, placements)
        return d.requires_grad_(x.requires_grad)

    return zip_map(place, params, param_shardings(mesh, params))


def sharded_opt_init(opt, mesh, trainable: Params):
    """The optimizer state of ``trainable``: the optimizers build each
    moment on its parameter's placements (AdamW's mu and nu, Adafactor's
    statistics less the dim each reduces), the ZeRO-equivalent
    optimizer-state sharding; the step count is a plain tensor, the
    same on every process."""
    return opt.init(trainable)


def replicated(mesh) -> List:
    """Every mesh dim ``Replicate``."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in range(mesh.ndim)]


def batch_sharding(mesh) -> List:
    """The placements of a data array: the leading (batch) dim over
    (dp, fsdp), dp outermost; replicated over the other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if ax in ("dp", "fsdp") else Replicate() for ax in AXES]


def n_data(mesh) -> int:
    """dp * fsdp: the processes a batch's rows are split over."""
    sizes = mesh_sizes(mesh)
    return sizes["dp"] * sizes["fsdp"]


def row_range(mesh, n: int) -> Tuple[int, int]:
    """[start, stop) of this process's rows of an ``n``-row batch: its
    place among the :func:`n_data` row shards, dp major, as
    ``P(("dp", "fsdp"))`` orders them."""
    coord = mesh.get_coordinate()
    index = coord[AXES.index("dp")] * mesh.size(AXES.index("fsdp")) \
        + coord[AXES.index("fsdp")]
    per = n // n_data(mesh)
    return index * per, (index + 1) * per


def _check_rows(mesh, n: int) -> None:
    k = n_data(mesh)
    if n % k != 0:
        raise ValueError(
            f"batch dimension {n} is not divisible by dp*fsdp = {k} "
            f"(mesh {mesh_sizes(mesh)}); pick batch_size / chunk_size / "
            f"eval n as a multiple of {k}")


def _map_leaves(fn, tree):
    if hasattr(tree, "map") and not torch.is_tensor(tree):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree, device=None):
    """Every array of ``tree`` (tensors, numpy arrays, a batch dataclass
    with ``map``) as a DTensor whose batch dim is sharded over (dp,
    fsdp); leaves share a leading batch dim divisible by dp * fsdp
    (checked here with a config-level error, not a failure mid-rollout).

    Every process must pass the SAME global array — the framework's
    loaders are seed-deterministic and host rewards go through
    :func:`~trlx_tpu_torch.parallel.runtime.broadcast_host_floats` —
    and each keeps its own rows, with no communication (replicated
    loading, trlx_tpu's design)."""
    leaves = []
    _map_leaves(leaves.append, tree)
    for leaf in leaves:
        b = leaf.shape[0] if len(getattr(leaf, "shape", ())) else 0
        _check_rows(mesh, b)
    placements = batch_sharding(mesh)

    def place(x):
        if is_dtensor(x):
            return x
        x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        if device is not None:
            x = x.to(device)
        return _distribute(x, mesh, placements)

    return _map_leaves(place, tree)


def relayout_for_decode(params: Params, min_bytes: int = 2 << 30) -> Params:
    """The same tree, unchanged. trlx_tpu moves gpt-j-sized attention
    projections to a transposed at-rest layout for the TPU's decode
    matvecs; a CUDA tensor's layout is its strides, and the decode path
    here reads the row-major projections as they are."""
    return params


# -- compute on the mesh: each process's rows, parameters gathered on use --


def _tp_dim(x) -> Optional[int]:
    """The tensor dim a DTensor shards over ``tp``, or None."""
    from torch.distributed.tensor import Shard

    pl = x.placements[AXES.index("tp")]
    return pl.dim if isinstance(pl, Shard) else None


def unshard(x, keep_tp: bool = False, keep_pp: bool = False):
    """A parameter as a plain tensor on this process: the whole of it, or
    with ``keep_tp`` this process's tp shard of it (a leaf that
    :class:`TensorParallel` compute reads as a column or row shard), and
    with ``keep_pp`` this stage's slab of a trunk whose layer axis shards
    over pp (trlx_tpu_torch.ops.pipeline_parallel). A DTensor is gathered
    over every other mesh dim; when it requires grad, the gather's
    backward treats the gradient as a partial sum over (dp, fsdp, sp) —
    each process differentiates its own rows and, under sp, its own
    chunk of positions — as replicated over the other axes, and as this
    process's shard over tp when kept, so the parameter's gradient
    arrives summed and in its own shards. A plain tensor comes back as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard

    tp_dim = _tp_dim(x) if keep_tp else None
    tp_pl = Replicate() if tp_dim is None else Shard(tp_dim)
    pp_pl = x.placements[AXES.index("pp")] if keep_pp else Replicate()
    target = [tp_pl if ax == "tp" else pp_pl if ax == "pp" else Replicate()
              for ax in AXES]
    y = x.redistribute(x.device_mesh, target)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return y.to_local()
    # a size-1 sp axis holds whole sequences: no sum over it
    partial = ("dp", "fsdp", "sp") \
        if x.device_mesh.size(AXES.index("sp")) > 1 else ("dp", "fsdp")
    return y.to_local(grad_placements=[
        Partial() if ax in partial else tp_pl if ax == "tp"
        else pp_pl if ax == "pp" else Replicate() for ax in AXES])


def unshard_tree(tree, into: Optional[dict] = None, tp=None,
                 keep_pp: bool = False):
    """:func:`unshard` on every leaf of nested dicts / lists / tuples;
    with ``tp`` (a :class:`TensorParallel`) the leaves of every
    ``blocks`` subtree keep their tp shards, and with ``keep_pp`` the
    frozen trunk's blocks (``frozen_base`` / ``blocks``) keep their pp
    slab; the rest are whole.

    With ``into`` (a dict the caller keeps; no gradient, every leaf
    whole) each gathered leaf lands in a buffer kept there by its path,
    the same storage on every call, so a captured CUDA graph that reads
    it reads the newest values; a leaf replicated over the whole mesh is
    its own shard, with no copy."""
    if into is None:
        return _map_with_path(
            lambda path, x: unshard(
                x, tp is not None and "blocks" in path,
                keep_pp and "frozen_base" in path and "blocks" in path),
            tree)
    from torch.distributed.tensor import Replicate

    def keep(path, x):
        if not is_dtensor(x):
            return x
        if all(isinstance(pl, Replicate) for pl in x.placements):
            return x.to_local()
        full = x.full_tensor()
        buf = into.get(path)
        if buf is None or buf.shape != full.shape or buf.dtype != full.dtype:
            into[path] = buf = full
        else:
            buf.copy_(full)
        return buf

    with torch.no_grad():
        return _map_with_path(keep, tree)


class TensorParallel:
    """Megatron's tensor parallelism over a mesh's tp group: the two
    operators :func:`~trlx_tpu_torch.models.transformer.block_apply`
    puts around a block's column- and row-parallel projections.
    ``enter`` is the identity whose backward sums the gradient over the
    group (each process's column shard sees only its part of it);
    ``reduce`` sums the row-parallel partial products over the group,
    and its backward is the identity.

    ``attn`` / ``mlp``: whether the attention and the MLP run on this
    process's shards (always here; the serve mesh's subclass,
    trlx_tpu_torch.serve.layouts ``DecodeParallel``, runs a sublayer tp
    does not divide whole width)."""

    attn = True
    mlp = True

    def __init__(self, mesh):
        self.group = mesh.get_group(AXES.index("tp"))
        self.size = mesh.size(AXES.index("tp"))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterTp.apply(x, self.group)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        return _ReduceTp.apply(y, self.group)


class _EnterTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist

        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def tensor_parallel(mesh, spec) -> Optional[TensorParallel]:
    """Megatron compute over the mesh's tp group for a model ``spec``, or
    None: with tp 1, or when tp does not divide the query heads, the KV
    heads and the MLP width (every block leaf's rule then keeps its tp
    shard, and a column shard is whole heads). Without it each tp
    process runs the whole width of its rows, its parameters gathered
    whole, and the flash kernels alone split the heads."""
    tp = mesh_sizes(mesh)["tp"]
    if tp == 1 or spec.n_head % tp or spec.kv_heads % tp \
            or spec.d_ff % tp:
        return None
    return TensorParallel(mesh)


def local_rows(x):
    """A batch-sharded DTensor's rows on this process (a plain tensor
    comes back as it is)."""
    return x.to_local() if is_dtensor(x) else x


def whole(x):
    """A batch-sharded DTensor as the whole global batch on every process
    (a plain tensor comes back as it is)."""
    return x.full_tensor() if is_dtensor(x) else x


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's rows ``x`` (a plain tensor) -> the whole global
    batch, the same on every process. Differentiable: the backward hands
    each process the gradient of its own rows, which is right when what
    follows is computed identically on every process (the losses and
    statistics of the global batch). Without a mesh, ``x`` itself."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, mesh, batch_sharding(mesh),
                              run_check=False).full_tensor()


def rows_of(x: torch.Tensor, mesh) -> torch.Tensor:
    """This process's rows of a global (replicated) batch tensor; without
    a mesh, ``x`` itself."""
    if mesh is None:
        return x
    _check_rows(mesh, x.shape[0])
    start, stop = row_range(mesh, x.shape[0])
    return x[start:stop]


# -- optimizer arithmetic on each process's shards -------------------------


def local(x):
    """A DTensor's shard on this process (a plain tensor as it is): the
    optimizers update shards in place with plain ops and sum what they
    reduce themselves (:func:`sum_over_shards`), so no op goes through
    DTensor's per-op dispatch."""
    return x.to_local() if is_dtensor(x) else x


def like(template, x_local):
    """``x_local`` as a DTensor with ``template``'s mesh, placements and
    global shape when ``template`` is a DTensor (``x_local`` is this
    process's shard of it); else ``x_local`` itself."""
    if not is_dtensor(template):
        return x_local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x_local, template.device_mesh,
                              template.placements, run_check=False,
                              shape=template.shape,
                              stride=template.stride())


def on_placements(g, template):
    """Gradient ``g`` on ``template``'s placements: autograd can hand a
    gradient back on other placements than its parameter's (replicated
    where the parameter is sharded), and the in-place update and the
    moments must stay on the parameter's."""
    if is_dtensor(template) and is_dtensor(g) \
            and tuple(g.placements) != tuple(template.placements):
        return g.redistribute(template.device_mesh, template.placements)
    return g


def sum_over_shards(x: torch.Tensor, template, dims=None) -> torch.Tensor:
    """Sum ``x`` — this process's partial reduction of ``template``'s
    shard over tensor ``dims`` (None: every dim) — across the processes
    holding the other shards of those dims, in place; the identity for a
    plain template."""
    if not is_dtensor(template):
        return x
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(template.placements):
        if isinstance(pl, Shard) and (dims is None or pl.dim in dims) \
                and template.device_mesh.size(i) > 1:
            dist.all_reduce(x, group=template.device_mesh.get_group(i))
    return x


def replication(template) -> int:
    """How many processes hold each element of ``template`` (1 for a plain
    tensor): the product of its replicated mesh dims' sizes."""
    if not is_dtensor(template):
        return 1
    from torch.distributed.tensor import Shard

    n = 1
    for i, pl in enumerate(template.placements):
        if not isinstance(pl, Shard):
            n *= template.device_mesh.size(i)
    return n


def dropped_dim_placements(placements, d: int) -> List:
    """The placements of a reduction over tensor dim ``d`` of a tensor on
    ``placements``: a mesh dim that sharded ``d`` now replicates, one
    that sharded a later dim shards the dim before it."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for pl in placements:
        if isinstance(pl, Shard) and pl.dim == d:
            out.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > d:
            out.append(Shard(pl.dim - 1))
        else:
            out.append(pl)
    return out


def zeros_on(template, shape, placements, dtype) -> torch.Tensor:
    """Zeros of global ``shape`` on ``template``'s mesh with
    ``placements`` (a plain tensor on its device when it is plain)."""
    if not is_dtensor(template):
        return torch.zeros(shape, dtype=dtype, device=template.device)
    from torch.distributed.tensor import zeros

    return zeros(shape, dtype=dtype, device_mesh=template.device_mesh,
                 placements=placements)
