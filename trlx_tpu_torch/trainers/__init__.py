"""RL trainer base and registry (port of trlx_tpu.trainers).

The abstract surface (``act`` / ``sample`` / ``learn`` /
``get_components`` / ``intervals`` / ``push_to_store``) is trlx_tpu's;
parameters and optimizer state are tensors the trainer holds and
updates in place on its device. :func:`build_optimizer` is optax's
``chain(clip_by_global_norm, adamw)`` with a schedule, written out; both
trainers build theirs with it.

Durability (trlx_tpu's ``BaseRLTrainer`` surface): ``save`` (a step
checkpoint under ``train.checkpoint_dir`` with ``keep_checkpoints``
retention, or a plain save to a named directory), ``load``,
``maybe_resume`` (``train.resume_from``: a path, or ``auto`` for the
newest checkpoint, a fresh start when there is none), the StepGuard
hooks behind ``train.max_bad_steps`` and SIGTERM preemption
(trlx_tpu_torch.utils.{checkpoint,faults,preemption}).

The run floor (trlx_tpu's same hooks): the telemetry session started at
construction (``train.telemetry``), the per-iteration observability
payload (``_telemetry_stats``), the ``telemetry.json`` / ``trace.jsonl``
flushes, the run supervisor and its containment (``_make_supervisor``,
``_contain_stall``, the walltime and stall stop folded into
``_preempt``), the supervised and bounded ``save``, and the memory-fit
pre-check (``_check_memory_fit``).

Training on a device mesh (trlx_tpu_torch.parallel): ``train.mesh`` with
``dp`` / ``fsdp`` / ``tp`` above 1 (under ``torchrun``), or an explicit
``mesh=`` from ``build_mesh``, puts the parameters and the optimizer
moments on the mesh as DTensors (``_shard_model_state``); the steps run
each process's rows with the parameters gathered on use, and the
optimizers update each process's shards (:func:`global_norm` and
:class:`Adafactor` sum what they reduce across the shards). ``sp`` above
1 runs every training and scoring forward on each process's chunk of
positions with ring attention (trlx_tpu_torch.ops.ring_attention), which
then takes precedence over ``model.fused_attention``; ``pp`` above 1
runs the frozen trunk as a GPipe schedule
(trlx_tpu_torch.ops.pipeline_parallel, ``_pp_kwargs``). The two do not
combine, as in trlx_tpu (:func:`check_ported`).

Pretrained weights: with no ``model.model_spec`` the trainers import
``model.model_path`` through trlx_tpu_torch.models.hf_import
(:meth:`BaseRLTrainer._load_or_spec`); a failed load raises, never a
silent random init.
"""

import os
import sys
from abc import abstractmethod
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.models.generation import RolloutDecoder
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.parallel import (
    initialize_runtime,
    mesh_from_config,
    mesh_sizes,
    shard_batch,
    shard_params,
    sharded_opt_init,
)
from trlx_tpu_torch.parallel.sharding import (
    dropped_dim_placements,
    tensor_parallel,
    unshard_tree,
    is_dtensor,
    like,
    local,
    n_data,
    on_placements,
    replication,
    sum_over_shards,
    zeros_on,
)
from trlx_tpu_torch.utils import (
    DTYPES,
    cosine_schedule,
    is_main_process,
    resolve_device,
)
from trlx_tpu_torch.supervisor import RunSupervisor, bounded_call, chaos
from trlx_tpu_torch.utils.checkpoint import (
    find_latest_checkpoint,
    restore_components,
    save_components,
    save_step_checkpoint,
)
from trlx_tpu_torch.utils.faults import StepGuard
from trlx_tpu_torch.utils.preemption import PreemptionGuard
from trlx_tpu_torch.utils.registry import BuiltinLoader, make_register

_TRAINERS: Dict[str, type] = {}
_load_builtins = BuiltinLoader(("trlx_tpu_torch.trainers.ppo_trainer",
                                "trlx_tpu_torch.trainers.ilql_trainer"))

#: Decorator registering a trainer class under a string name.
register_trainer = make_register(_TRAINERS)


def check_ported(config, mesh=None) -> None:
    """Raise, before any process group or mesh is built, for a mesh that
    neither trlx_tpu nor the port runs: ``sp`` and ``pp`` both above 1,
    in ``train.mesh`` or in an explicit mesh, with trlx_tpu's
    message."""
    sizes = dict(config.train.mesh or {})
    if mesh is not None:
        sizes.update(mesh_sizes(mesh))
    if sizes.get("sp", 1) > 1 and sizes.get("pp", 1) > 1:
        raise ValueError(
            "train.mesh pp > 1 cannot combine with sp > 1: ring "
            "attention runs its own shard_map over sp, which cannot "
            "nest inside the GPipe stage shard_map")


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    tree_map(out.append, tree)
    return out


@torch.no_grad()
def copy_into(dst, src) -> None:
    """Copy tree ``src`` into tree ``dst``'s tensors in place (same
    structure and shapes; a DTensor ``dst`` takes its own shard of a
    DTensor ``src``)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, x in zip(dst, src):
            copy_into(d, x)
    elif is_dtensor(dst):
        local(dst).copy_(local(on_placements(src, dst)))
    else:
        dst.copy_(src)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the L2 norm over every gradient, float32.
    On DTensor gradients (on their parameters' placements) each process
    sums its shards' squares, each element weighted by one over the
    number of processes holding it, and one all-reduce adds the
    processes' sums: the same norm on every process."""
    if not any(is_dtensor(g) for g in grads):
        return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    import torch.distributed as dist

    total = sum((local(g).float() ** 2).sum() / replication(g)
                for g in grads)
    dist.all_reduce(total)
    return torch.sqrt(total)


class AdamW:
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adamw(schedule, weight_decay=..., mu_dtype=...))`` on a list of
    parameter tensors, updated in place:

    1. clip: with g_norm the global norm, gradients are kept when
       g_norm < max_norm, else scaled by max_norm / g_norm;
    2. Adam moments (mu stored in ``mu_dtype``, nu float32) with bias
       correction at the incremented count, update m / (sqrt(v) + eps);
    3. decoupled weight decay: + weight_decay * param;
    4. the step: param -= schedule(count) * update, the schedule read at
       the count BEFORE this step's increment.

    The count is a 0-d int32 tensor on the parameters' device, and the
    schedule and both bias corrections are computed from it there: no
    step reads anything back to the host. ``ok`` (a 0-d bool tensor) is
    the commit gate: where it is False the parameters, both moments and
    the count keep their values, as optax's state does under the
    reference's ``jnp.where``; without it nothing is selected.
    """

    def __init__(self, schedule: Callable, max_norm: float,
                 weight_decay: float, mu_dtype=torch.float32, b1=0.9,
                 b2=0.999, eps=1e-8):
        self.schedule = schedule
        self.max_norm = float(max_norm)
        self.weight_decay = float(weight_decay)
        self.mu_dtype = mu_dtype
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict:
        leaves = _leaves(params)
        return {
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device),
            "mu": [like(p, torch.zeros_like(local(p), dtype=self.mu_dtype))
                   for p in leaves],
            "nu": [like(p, torch.zeros_like(local(p), dtype=torch.float32))
                   for p in leaves],
        }

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict, ok: Optional[torch.Tensor] = None,
             g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of ``params`` in place, committed only where ``ok``
        (when given); returns the pre-clip global gradient norm. DTensor
        parameters update their shards on this process."""
        grads = [on_placements(g, p) for p, g in zip(params, grads)]
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        count = state["count"]
        new_count = count + 1
        dev = g_norm.device

        def corr(b):  # 1 - b ** count, float32 on the device
            base = torch.full((), b, dtype=torch.float32, device=dev)
            return 1 - torch.pow(base, new_count.float())

        bc1, bc2 = corr(self.b1), corr(self.b2)
        lr = self.schedule(count)
        for i, (p, g) in enumerate(zip(params, grads)):
            p, g = local(p), local(g).float()
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            # b1 * mu in the moment's own dtype, b1 rounded to it first,
            # as optax's weak-typed scalar times a bfloat16 moment is
            mu_prev, nu_prev = local(state["mu"][i]), local(state["nu"][i])
            mu = (1 - self.b1) * g + mu_prev * torch.full(
                (), self.b1, dtype=mu_prev.dtype, device=dev)
            nu = (1 - self.b2) * g * g + self.b2 * nu_prev
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            mu = mu.to(self.mu_dtype)
            if ok is None:
                p.add_(-lr * update)
            else:
                p.copy_(torch.where(ok, p + (-lr * update), p))
                mu = torch.where(ok, mu, mu_prev)
                nu = torch.where(ok, nu, nu_prev)
            state["mu"][i] = like(state["mu"][i], mu)
            state["nu"][i] = like(state["nu"][i], nu)
        state["count"] = new_count if ok is None \
            else torch.where(ok, new_count, count)
        return g_norm


#: optax.adafactor's defaults, as the reference builds it
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_SCALE = 1e-3


def factored_dims(shape):
    """optax's ``_factored_dims``: (d1, d0), the second-largest and the
    largest axis (``np.argsort`` order), when the second-largest has at
    least ``ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR`` entries; else None (a 1-D
    leaf or a small one keeps an unfactored second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adafactor(learning_rate=schedule, weight_decay_rate=...))`` as
    optax 0.2.6 builds it, on a list of float32 parameters updated in
    place. Per leaf, after the global-norm clip (AdamW's rule):

    1. ``scale_by_factored_rms`` (decay_rate 0.8, offset 0,
       min_dim_size_to_factor 128, eps 1e-30): with
       beta = 1 - (count + 1) ** -0.8 and g2 = g * g + eps, a factored
       leaf keeps row and column means of g2 over its two largest axes
       (``factored_dims``), v_row = beta v_row + (1 - beta) mean(g2, d0)
       and v_col likewise over d1, and scales g by
       (v_row / mean(v_row)) ** -0.5 and v_col ** -0.5; any other leaf
       keeps v = beta v + (1 - beta) g2 and scales g by v ** -0.5;
    2. ``clip_by_block_rms(1.0)``: u / max(1, rms(u));
    3. ``scale_by_learning_rate``: u * schedule(count);
    4. ``scale_by_param_block_rms()``: u * max(rms(p), 1e-3);
    5. ``add_decayed_weights``: + weight_decay * p (after the learning
       rate, so the decay is not scaled by it; skipped at 0, as the
       reference passes ``weight_decay or None``);
    6. ``scale(-1)``: p - u.

    The state is optax's ``FactoredState`` layout (``v_row``, ``v_col``,
    ``v`` per leaf, [1] zeros where a leaf has none) with one 0-d int32
    count on the device: the factored statistics' count and the
    schedule's advance together. ``ok`` is the commit gate, as in
    :class:`AdamW`: where it is False the parameters, every moment and
    the count keep their values, selected on the device."""

    def __init__(self, schedule: Callable, max_norm: float,
                 weight_decay: float = 0.0):
        self.schedule = schedule
        self.max_norm = float(max_norm)
        self.weight_decay = float(weight_decay or 0.0)

    def init(self, params) -> Dict:
        leaves = _leaves(params)
        state = {"count": torch.zeros((), dtype=torch.int32,
                                      device=leaves[0].device),
                 "v_row": [], "v_col": [], "v": []}
        for p in leaves:
            dims = factored_dims(tuple(p.shape))
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"].append(one)
                state["v_col"].append(one.clone())
                state["v"].append(like(p, torch.zeros_like(local(p))))
            else:
                # a DTensor leaf's statistics shard like the leaf, less
                # the dim each reduces over
                d1, d0 = dims
                shape = list(p.shape)
                pl = getattr(p, "placements", None)
                state["v_row"].append(zeros_on(
                    p, shape[:d0] + shape[d0 + 1:],
                    pl and dropped_dim_placements(pl, d0), p.dtype))
                state["v_col"].append(zeros_on(
                    p, shape[:d1] + shape[d1 + 1:],
                    pl and dropped_dim_placements(pl, d1), p.dtype))
                state["v"].append(one.clone())
        return state

    @staticmethod
    def _mean(x: torch.Tensor, leaf, dim=None, leaf_dim=None,
              keepdim=False) -> torch.Tensor:
        """``x.mean(dim)`` (every dim when None) where ``x`` is this
        process's shard of ``leaf`` or of a statistic of it whose
        ``dim`` is the leaf's ``leaf_dim``: on a DTensor leaf the sum
        goes over the processes holding that dim's other shards, then
        divides by its global size (the leaf's numel for every dim)."""
        if not is_dtensor(leaf):
            return torch.mean(x) if dim is None \
                else x.mean(dim=dim, keepdim=keepdim)
        if dim is None:
            return sum_over_shards(torch.sum(x), leaf) / leaf.numel()
        return sum_over_shards(x.sum(dim=dim, keepdim=keepdim), leaf,
                               dims=[leaf_dim]) / leaf.shape[leaf_dim]

    def _rms(self, x: torch.Tensor, leaf=None) -> torch.Tensor:
        return torch.sqrt(self._mean(x * x, leaf))

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict, ok: Optional[torch.Tensor] = None,
             g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of ``params`` in place, committed only where ``ok``
        (when given); returns the pre-clip global gradient norm. DTensor
        parameters update their shards on this process; the row and
        column means and the block RMS values are summed over the
        processes holding the other shards, so every process computes
        optax's statistics of the whole leaf."""
        grads = [on_placements(g, p) for p, g in zip(params, grads)]
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < self.max_norm
        count = state["count"]
        new_count = count + 1
        beta = 1.0 - torch.pow(new_count.float(), -ADAFACTOR_DECAY_RATE)
        lr = self.schedule(count)
        for i, (leaf, g) in enumerate(zip(params, grads)):
            p, g = local(leaf), local(g).float()
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            g2 = g * g + ADAFACTOR_EPS
            v_row, v_col, v = (local(state["v_row"][i]),
                               local(state["v_col"][i]),
                               local(state["v"][i]))
            dims = factored_dims(tuple(leaf.shape))
            if dims is None:
                v = beta * v + (1.0 - beta) * g2
                u = g * torch.pow(v, -0.5)
            else:
                d1, d0 = dims
                v_row = beta * v_row + (1.0 - beta) * self._mean(
                    g2, leaf, d0, d0)
                v_col = beta * v_col + (1.0 - beta) * self._mean(
                    g2, leaf, d1, d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                # v_row's dim reduced_d1 is the leaf's d1, sharded alike
                row_factor = torch.pow(
                    v_row / self._mean(v_row, leaf, reduced_d1, d1,
                                       keepdim=True), -0.5)
                col_factor = torch.pow(v_col, -0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            u = u / torch.clamp(
                self._rms(u, leaf) / ADAFACTOR_CLIPPING_THRESHOLD, min=1.0)
            u = lr * u
            rms_p = self._rms(p, leaf)
            u = u * torch.where(rms_p <= ADAFACTOR_MIN_SCALE,
                                torch.full_like(rms_p, ADAFACTOR_MIN_SCALE),
                                rms_p)
            if self.weight_decay:
                u = u + self.weight_decay * p
            if ok is None:
                p.sub_(u)
            else:
                p.copy_(torch.where(ok, p - u, p))
                v_row = torch.where(ok, v_row, local(state["v_row"][i]))
                v_col = torch.where(ok, v_col, local(state["v_col"][i]))
                v = torch.where(ok, v, local(state["v"][i]))
            state["v_row"][i] = like(state["v_row"][i], v_row)
            state["v_col"][i] = like(state["v_col"][i], v_col)
            state["v"][i] = like(state["v"][i], v)
        state["count"] = new_count if ok is None \
            else torch.where(ok, new_count, count)
        return g_norm


def build_optimizer(train_config, sched=None):
    """Grad clip + the configured optimizer + LR schedule (default:
    cosine anneal from ``learning_rate_init`` to ``learning_rate_target``
    over ``total_steps``), as trlx_tpu builds it with optax:
    ``train.optimizer`` "adamw" (:class:`AdamW`,
    ``train.adam_moment_dtype`` for its first moment) or "adafactor"
    (:class:`Adafactor`: a factored second moment and no first, so its
    state is ~0 bytes a parameter)."""
    if sched is None:
        sched = cosine_schedule(train_config.learning_rate_init,
                                train_config.total_steps,
                                lr_min=train_config.learning_rate_target)
    name = getattr(train_config, "optimizer", "adamw").lower()
    if name == "adafactor":
        return Adafactor(sched, train_config.grad_clip,
                         train_config.weight_decay)
    if name != "adamw":
        raise ValueError(
            f"train.optimizer '{name}' is not one of: adamw, adafactor")
    return AdamW(sched, train_config.grad_clip, train_config.weight_decay,
                 mu_dtype=DTYPES[getattr(train_config, "adam_moment_dtype",
                                         "float32")])


class BaseRLTrainer:
    """Abstract RL trainer: owns the tokenizer, the parameter tree, the
    optimizer state, the rollout store and the step functions."""

    def __init__(self, config, train_mode: bool = True, mesh=None,
                 device=None):
        check_ported(config, mesh)
        self.config = config
        self.train_mode = train_mode
        self.store = None
        self.device = resolve_device(device)
        # torchrun's world joins first (NCCL on cuda:LOCAL_RANK); one
        # process not under torchrun stays as it is
        initialize_runtime(device_type=self.device.type)
        #: the DeviceMesh the model state lives on, or None (plain
        #: tensors on one device): an explicit ``mesh``, else
        #: ``train.mesh`` over the world when it is more than one process
        #: or asks for more than one
        self.mesh = mesh if mesh is not None \
            else mesh_from_config(config.train, self.device.type)
        #: the blocks' Megatron compute over tp (``_tensor_parallel``)
        self.tp = None
        #: this process's chunk of positions when the mesh has sp > 1
        #: (trlx_tpu_torch.ops.ring_attention.SequenceSplit), else None
        self.sp = None
        if self.mesh is not None:
            check_ported(config, self.mesh)
            if mesh_sizes(self.mesh)["sp"] > 1:
                from trlx_tpu_torch.ops.ring_attention import SequenceSplit

                self.sp = SequenceSplit(self.mesh)
            if self.mesh.device_type != self.device.type:
                raise ValueError(
                    f"the mesh is on {self.mesh.device_type} but the "
                    f"trainer on {self.device}")
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        # the telemetry session (train.telemetry, default on) starts at
        # construction, before any resume or rollout, so their counters
        # and spans land in the run's registry; a fresh trainer is a
        # fresh session
        self._telemetry = telemetry.start_from_config(config)
        # per-token FLOPs and tokens per sample for throughput/* and MFU;
        # the subclasses set their analytic values
        self._flops_per_token = 0
        self._tokens_per_sample = 0
        #: the run supervisor of the latest learn() (its watchdog's
        #: stalls and first-call times stay readable after it)
        self.supervisor: Optional[RunSupervisor] = None
        #: generate's captured decode steps and their buffers, one per
        #: rollout shape; they read the parameters where they live, so a
        #: rollout after an update, a load or a rollback (all in place)
        #: decodes with the new weights
        self.decoder = RolloutDecoder()

    def _to_device(self, tree):
        """Host tensors (or a tree of them) -> the trainer's device, whole
        on every process."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)

    def _put(self, tree):
        """Batch data (host or device tensors, a tree or a batch with
        ``map``) -> the trainer's device; on a mesh through
        ``shard_batch``: DTensors whose rows shard over (dp, fsdp), each
        process keeping its own (every process passes the same global
        batch)."""
        if self.mesh is None:
            return self._to_device(tree)
        return shard_batch(self.mesh, tree, device=self.device)

    def _pp_kwargs(self, n_bottom_layers: int, *batch_sizes) -> Dict:
        """Policy-dataclass kwargs that turn on GPipe for the frozen trunk
        when the mesh has pp > 1 (trlx_tpu_torch.ops.pipeline_parallel),
        validated up front with trlx_tpu's messages: the frozen layer
        count must split evenly into stages and every batch the forward
        sees must split into microbatches — as a whole batch (trlx_tpu's
        check) and as each process's rows over dp * fsdp (the port's
        stages run those)."""
        if self.mesh is None or mesh_sizes(self.mesh)["pp"] <= 1:
            return {}
        pp = mesh_sizes(self.mesh)["pp"]
        n_micro = self.config.train.pp_num_microbatches
        if n_bottom_layers == 0:
            # 0 % pp == 0: without this check a fully-unfrozen model
            # would pipeline an EMPTY trunk, every stage idle
            raise ValueError(
                f"pipeline parallelism: num_layers_unfrozen leaves zero "
                f"frozen trunk layers, but train.mesh pp={pp} pipelines "
                f"only the frozen trunk — the entire pp device slice "
                f"would sit idle. Freeze at least pp layers (lower "
                f"num_layers_unfrozen) or set pp: 1.")
        if n_bottom_layers % pp:
            raise ValueError(
                f"pipeline parallelism: the frozen trunk has "
                f"{n_bottom_layers} layers, not divisible into pp={pp} "
                f"stages; adjust num_layers_unfrozen or the pp extent")
        rows = n_data(self.mesh)
        for b in batch_sizes:
            if b % n_micro or (b // rows) % n_micro:
                raise ValueError(
                    f"pipeline parallelism: batch of {b} rows is not "
                    f"divisible into train.pp_num_microbatches={n_micro} "
                    f"microbatches"
                    + ("" if b % n_micro else
                       f" on each of dp * fsdp = {rows} processes"))
        return {"pp_mesh": self.mesh, "pp_n_micro": n_micro}

    def _tensor_parallel(self, spec):
        """Set and return ``self.tp``: Megatron compute over the mesh's tp
        group for ``spec`` (trlx_tpu_torch.parallel.sharding
        ``tensor_parallel``), or None (no mesh, tp 1, or a width tp does
        not split)."""
        self.tp = None if self.mesh is None \
            else tensor_parallel(self.mesh, spec)
        return self.tp

    def _forward_params(self):
        """The parameter tree the training and scoring forwards read: the
        trainer's own without a mesh; on one each leaf gathered on use
        (differentiably where it requires grad), the blocks' tp shards
        kept under tp compute and the frozen trunk's pp slab under
        pp."""
        if self.mesh is None:
            return self.params
        return unshard_tree(self.params, tp=self.tp,
                            keep_pp=mesh_sizes(self.mesh)["pp"] > 1)

    def _whole_params(self):
        """The parameter tree as whole plain tensors, for decoding
        (rollouts, evaluation): the trainer's own tensors without a mesh;
        on one, each leaf gathered into a buffer the trainer keeps
        (``unshard_tree(into=)``), so the decoder's captured steps read
        fresh values at stable addresses."""
        if self.mesh is None:
            return self.params
        if not hasattr(self, "_gathered"):
            self._gathered = {}
        return unshard_tree(self.params, into=self._gathered)

    def _pad_rows(self, tree):
        """(padded tree, real row count): the final row repeated until the
        batch dim is a multiple of dp * fsdp, for ad-hoc batch sizes (eval
        prompts, ``sample`` calls) the mesh could not shard; callers
        slice results back to the real count. No mesh: as it is."""
        leaves = []
        tree_map(leaves.append, tree)
        n = leaves[0].shape[0]
        if self.mesh is None:
            return tree, n
        pad = (-n) % n_data(self.mesh)
        if pad == 0:
            return tree, n

        def grow(x):
            if torch.is_tensor(x):
                return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            x = np.asarray(x)
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

        return tree_map(grow, tree), n

    def _shard_model_state(self, params):
        """(params, opt_state) of a plain parameter tree: on a mesh every
        leaf becomes a DTensor on trlx_tpu's placements and the optimizer
        moments take their parameters' placements; without one, as it
        is."""
        if self.mesh is not None:
            params = shard_params(self.mesh, params)
        return params, sharded_opt_init(self.opt, self.mesh,
                                        params["trainable"])

    def _sync(self) -> None:
        """Wait for the device (host spans then time device work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_attention_fn(self):
        """Attention for train-time forwards, in trlx_tpu's precedence:
        ring attention when the mesh has sp > 1 (each block pair through
        the flash kernels on the card, chunks shorter than the seam's
        ``_MIN_FUSED_T`` through their plain versions); the flash kernels
        when ``model.fused_attention`` is true (sequences shorter than
        the seam's floor take the dense path, as forced runs of the JAX
        package do); else None = dense attention. The JAX package also
        turns the kernel on by itself at T >= 1024 on a TPU — a threshold
        measured on a TPU; the port sets its own from H100 measurements
        in a later change, and until then only an explicit
        ``fused_attention: true`` selects the kernels. Generation takes
        neither: its prefill attends densely, and each decode step
        through the paged-decode kernel over the dense cache read as
        pages (trlx_tpu_torch.models.generation ``generate``)."""
        if self.sp is not None:
            from trlx_tpu_torch.ops.ring_attention import make_sp_attention_fn

            return make_sp_attention_fn(self.mesh)
        if self.config.model.fused_attention:
            from trlx_tpu_torch.ops.flash_attention import (
                make_flash_attention_fn,
            )

            return make_flash_attention_fn(mesh=self.mesh,
                                           tp_heads=self.tp is not None)
        return None

    def _check_memory_fit(self, spec, frozen_dtype, ref_branch=True,
                          extra_trainable=0, extra_frozen=0,
                          embed_trainable=False) -> int:
        """Fail BEFORE allocation, with the options, when the model state
        clearly cannot fit the card: the parameters (frozen in
        ``frozen_dtype``; the trainable top and, with ``ref_branch``,
        its frozen reference copy) plus the AdamW moments of the
        trainable part, against the card's total memory from
        ``torch.cuda.mem_get_info``; on a mesh a card holds 1 / (fsdp *
        tp) of the state, as trlx_tpu divides. A deliberate lower bound (no
        activations, no CUDA context): a config that passes can still
        run out near the edge; one that fails would have. Skipped on
        the CPU and with ``TRLX_TPU_SKIP_MEMCHECK=1``.
        ``extra_trainable`` / ``extra_frozen`` add parameter counts for
        method heads (ILQL's Q / V heads and target-Q copies). Returns
        the estimate in bytes, checked or not."""
        d, f, L, V = spec.d_model, spec.d_ff, spec.n_layer, spec.vocab_size
        per_layer = 4 * d * d + 2 * d * f  # qkv / o + mlp (biases aside)
        k = self.config.model.num_layers_unfrozen
        k = L if k < 0 else min(k, L)
        embed = V * d + spec.n_positions * d
        # an untied lm_head lives in the trainable branch AND its ref copy
        lm_head = 0 if spec.tie_lm_head else V * d
        frozen_sz = torch.empty((), dtype=frozen_dtype).element_size()
        # optimizer-state bytes a parameter follow train.optimizer: fp32
        # AdamW 8 (mu + nu), bf16-mu AdamW 6, adafactor ~0 (its factored
        # second moment is O(rows + cols) a matrix)
        opt_name = getattr(self.config.train, "optimizer", "adamw").lower()
        if opt_name == "adafactor":
            opt_bytes = 0
        else:
            mu_dtype = getattr(self.config.train, "adam_moment_dtype",
                               "float32")
            opt_bytes = (2 if mu_dtype == "bfloat16" else 4) + 4
        embed_train = embed if embed_trainable else 0
        embed_frozen = 0 if embed_trainable else embed
        est = (
            ((L - k) * per_layer + embed_frozen) * frozen_sz
            + (k * per_layer + lm_head) * frozen_sz * (1 if ref_branch else 0)
            + (k * per_layer + lm_head + embed_train + extra_trainable)
            * (4 + opt_bytes)
            + extra_frozen * frozen_sz
        )
        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            sizes = mesh_sizes(mesh)
            est //= sizes["fsdp"] * sizes["tp"]
        if os.environ.get("TRLX_TPU_SKIP_MEMCHECK") \
                or self.device.type != "cuda":
            return est
        limit = torch.cuda.mem_get_info(self.device)[1]
        if est > int(limit * 1.05):
            dtype_opt = (
                "set model.param_dtype: bfloat16 (frozen trunk + ref "
                "branch storage; trainable/optimizer stay fp32), "
                if ref_branch else "")
            opt_hint = (
                f"set train.optimizer: adafactor (drops the {opt_bytes} "
                f"optimizer bytes/param), set train.adam_moment_dtype: "
                f"bfloat16, " if opt_bytes else "")
            raise ValueError(
                f"model state needs ~{est / 2**30:.1f} GB but the card has "
                f"{limit / 2**30:.1f} GB. Options: {dtype_opt}{opt_hint}"
                f"lower num_layers_unfrozen, or set TRLX_TPU_SKIP_MEMCHECK=1 "
                f"to try anyway.")
        return est

    def _load_or_spec(self, config):
        """(spec, trunk | None): the pretrained import
        (trlx_tpu_torch.models.hf_import) when no ``model.model_spec`` is
        configured, a from-config random init otherwise.

        A failing pretrained load RAISES instead of silently training a
        from-scratch model: a typo'd ``model_path`` must not pass for a
        successful run. Random init is asked for with
        ``model.model_spec``."""
        if config.model.model_spec is not None:
            return config.model.resolve_spec(), None
        from trlx_tpu_torch.models.hf_import import load_trunk_from_hf

        try:
            spec, embed, blocks, ln_f = load_trunk_from_hf(
                config.model.model_path)
        except Exception as e:
            raise RuntimeError(
                f"could not load pretrained weights for "
                f"'{config.model.model_path}': {e!r}. For a from-config "
                f"randomly-initialized model, set model.model_spec in the "
                f"config instead.") from e
        return spec, (embed, blocks, ln_f)

    def _main_process_log(self, log_fn: Callable) -> Callable:
        """Emit metrics from the main process only."""
        if log_fn is None or is_main_process():
            return log_fn
        return lambda stats: None

    def _make_tracker(self, log_fn: Callable = None):
        """The learn loops' sink: ``log_fn`` when given, else the
        ``train.tracker`` of the config (trlx_tpu_torch.utils.trackers:
        print, jsonl:<path>, wandb, none); main-process only."""
        from trlx_tpu_torch.utils.trackers import make_tracker

        return self._main_process_log(log_fn or make_tracker(self.config))

    def _telemetry_stats(self, samples_per_sec: float) -> Dict[str, float]:
        """The per-iteration observability payload the learn loops merge
        into their stats: ``time/*`` (each phase's LAST duration),
        ``fault/*`` and the other counters, ``device/*`` memory gauges,
        ``compile/*`` first-call latencies, and ``throughput/*`` from the
        loop's sample clock and the trainer's analytic FLOPs (MFU only
        where the card's peak is known). Empty with telemetry off."""
        tel = telemetry.current()
        if tel is None:
            return {}
        out = tel.tracker_stats()
        out["throughput/samples_per_sec"] = samples_per_sec
        if self._tokens_per_sample:
            tokens_per_sec = samples_per_sec * self._tokens_per_sample
            out["throughput/tokens_per_sec"] = tokens_per_sec
            mfu = telemetry.mfu_estimate(
                tokens_per_sec, self._flops_per_token, self.device)
            if mfu is not None:
                out["throughput/mfu"] = mfu
        return out

    def _maybe_flush_telemetry(self) -> None:
        """Every ``train.telemetry_flush_every`` iterations rewrite
        ``telemetry.json`` + ``trace.jsonl``, so a SIGKILL'd run still
        leaves them; a failed write is reported, never raised."""
        every = int(getattr(self.config.train, "telemetry_flush_every", 0))
        tel = telemetry.current()
        if every <= 0 or tel is None:
            return
        last = getattr(self, "_telemetry_flushed_at", 0)
        if self.iter_count - last < every:
            return
        self._telemetry_flushed_at = self.iter_count
        try:
            tel.write()
        except Exception as e:
            print(f"[trlx_tpu_torch] periodic telemetry flush failed "
                  f"({e!r}); continuing", file=sys.stderr, flush=True)

    def _finish_telemetry(self, kind: str, clock=None) -> None:
        """learn()-exit hook, on every exit path: the run's headline
        throughput, then ``telemetry.json`` + ``trace.jsonl``."""
        tel = telemetry.current()
        if tel is None:
            return
        if clock is not None and clock.total_samples:
            sps = clock.samples_per_second()
            tel.set_headline(f"{kind}_learn_samples_per_sec", sps,
                             "samples/s")
            if self._tokens_per_sample:
                tel.registry.set_gauge("throughput/tokens_per_sec",
                                       sps * self._tokens_per_sample)
        tel.finish()

    def push_to_store(self, data) -> None:
        self.store.push(data)

    def intervals(self, steps: int) -> Dict[str, bool]:
        """Which periodic actions fire at ``steps``."""
        t = self.config.train
        return {
            "do_log": steps % t.log_interval == 0,
            "do_eval": steps % t.eval_interval == 0,
            "do_save": steps > 0 and steps % t.checkpoint_interval == 0,
        }

    def _apply_update(self, loss, leaves, grads, stats,
                      kl_limit: float = 0.0) -> None:
        """The optimizer step on ``leaves`` with the commit gate when
        ``max_bad_steps > 0``: ``ok = isfinite(loss) & isfinite(grad_norm)``
        (and ``approx_kl <= kl_limit`` when the limit is > 0), selected on
        the device; ``stats`` gains ``grad_norm`` and, gated,
        ``bad_step``."""
        grads = [on_placements(g, p) for p, g in zip(leaves, grads)]
        g_norm = global_norm(grads)
        ok = None
        if self.guard_on:
            ok = torch.isfinite(loss) & torch.isfinite(g_norm)
            if kl_limit > 0:
                ok = ok & (stats["approx_kl"] <= kl_limit)
            stats["bad_step"] = 1.0 - ok.float()
        stats["grad_norm"] = self.opt.step(leaves, grads, self.opt_state,
                                           ok=ok, g_norm=g_norm)

    # -- durability ------------------------------------------------------ #

    @property
    def guard_on(self) -> bool:
        """Whether the steps carry the commit gate (``max_bad_steps``)."""
        return getattr(self.config.train, "max_bad_steps", 0) > 0

    def save(self, directory: str = None) -> None:
        """Checkpoint the components, crash-atomically
        (trlx_tpu_torch.utils.checkpoint). With no ``directory`` the save
        lands as ``checkpoint_dir/step_<iter_count>`` with a ``LATEST``
        marker and ``train.keep_checkpoints`` retention — the layout
        ``resume_from: auto`` and the rollback restore from.

        Supervised: the save is the watchdog's ``checkpoint_save`` phase
        and fires that chaos seam; with ``train.checkpoint_timeout`` it
        runs through a bounded worker, so a save wedged on a dead mount
        raises SeamTimeout instead of hanging the run."""
        t = self.config.train

        def write():
            if directory is not None:
                save_components(self.get_components(), directory)
                return
            save_step_checkpoint(self.get_components(), t.checkpoint_dir,
                                 step=getattr(self, "iter_count", 0),
                                 keep=getattr(t, "keep_checkpoints", 0))

        with supervisor.phase("checkpoint_save"):
            chaos.maybe_inject("checkpoint_save")
            timeout = float(getattr(t, "checkpoint_timeout", 0.0) or 0.0)
            if timeout > 0:
                bounded_call(write, timeout=timeout, label="checkpoint_save")
            else:
                write()

    def load(self, directory: str = None) -> None:
        """Restore from a checkpoint or a run directory (default
        ``checkpoint_dir``) into the trainer's own tensors."""
        self.set_components(restore_components(
            self.get_components(),
            directory or self.config.train.checkpoint_dir))

    def _rollback_to_latest(self) -> Optional[str]:
        """The StepGuard's rollback: restore the newest valid checkpoint
        under ``checkpoint_dir``; its path, or None when there is none."""
        directory = find_latest_checkpoint(self.config.train.checkpoint_dir)
        if directory is None:
            return None
        self.load(directory)
        return directory

    def _make_step_guard(self, log_fn):
        """The learn loops' divergence guard, from ``train.max_bad_steps``
        (disabled, and free, at 0)."""
        return StepGuard(max_bad_steps=getattr(self.config.train,
                                               "max_bad_steps", 0),
                         rollback_fn=self._rollback_to_latest, log=log_fn)

    def _observe_step(self, step_guard, stats) -> None:
        """Feed one step's verdict to the StepGuard. Only with the guard
        on does this read the ``bad_step`` flag (and the loss, grad norm
        and KL beside it) back to the host."""
        if step_guard is None or not step_guard.enabled:
            return
        host = {k: float(stats[k])
                for k in ("bad_step", "loss", "grad_norm", "approx_kl")
                if k in stats}
        bad = host.pop("bad_step", 0.0) > 0
        step_guard.observe(bad=bad, step=self.iter_count, detail=host)

    def _preempt(self, log_fn, guard, just_saved: bool = False,
                 sup=None) -> bool:
        """Checkpoint and return True when any process wants the loop to
        stop: SIGTERM (the preemption guard), the supervisor's walltime
        deadline, or a stall escalation that found the loop still alive.
        All three ride the guard's rank agreement
        (``PreemptionGuard.poll(extra=)``). ``just_saved``: an interval
        checkpoint fired at this boundary, so the second save is
        skipped."""
        local = sup is not None and sup.stop_requested()
        stop = local if guard is None else guard.poll(extra=local)
        if not stop:
            return False
        if not just_saved:
            self.save()
        reason = sup.stop_reason() if local else "preempted"
        log_fn({"iter": self.iter_count, reason: 1.0})
        return True

    def _make_supervisor(self) -> RunSupervisor:
        """The learn loop's run supervisor from the ``train.stall_*`` /
        ``max_walltime`` knobs (inert, but still a context manager, when
        they are 0), after installing the chaos schedule from
        ``$TRLX_TPU_CHAOS`` / ``train.chaos`` with fresh counters. Its
        rescue hook, for the ``checkpoint_exit`` escalation, runs on the
        watchdog thread while the main thread is wedged, bounded by
        ``train.checkpoint_timeout`` (or 120 s): it first waits for the
        card (every stream), so its copies read the parameters after the
        last update the main thread enqueued, then saves; a wedged
        kernel makes the wait, and so the rescue, time out."""
        chaos.configure_from(self.config.train)
        device = self.device

        def rescue():
            def sync_then_save():
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                self.save()

            bounded_call(sync_then_save, timeout=float(
                getattr(self.config.train, "checkpoint_timeout", 0.0)
                or 120.0), label="stall rescue checkpoint")

        self.supervisor = RunSupervisor.from_config(self.config.train,
                                                    rescue_fn=rescue)
        return self.supervisor

    def _contain_stall(self, log_fn) -> None:
        """StallError containment: a hung seam past its retry budget
        becomes a clean checkpoint-and-exit. Commit a resumable
        checkpoint (best effort: the stall may be the save path itself),
        log the verdict; the caller re-raises."""
        try:
            self.save()
        except Exception as e:
            print(f"[trlx_tpu_torch] stall-exit checkpoint failed ({e!r}); "
                  f"the last interval checkpoint remains the resume point",
                  flush=True)
        log_fn({"iter": self.iter_count, "stalled": 1.0})

    def _preemption_guard(self):
        """``PreemptionGuard(save_on_preemption, poll_interval)``: the
        interval is ``preempt_poll_interval`` or ``min(log_interval, 8)``."""
        t = self.config.train
        return PreemptionGuard(
            t.save_on_preemption,
            poll_interval=t.preempt_poll_interval or min(t.log_interval, 8))

    def maybe_resume(self) -> bool:
        """Restore from ``train.resume_from`` once per process; called at
        construction (before any rollout) and at the top of ``learn``.
        ``auto`` resolves to the newest valid checkpoint under
        ``checkpoint_dir`` and starts fresh when there is none. True when
        a restore happened."""
        directory = getattr(self.config.train, "resume_from", "")
        if not directory or getattr(self, "_resumed", False):
            return False
        if directory == "auto":
            directory = find_latest_checkpoint(
                self.config.train.checkpoint_dir)
            if directory is None:
                return False
        self.load(directory)
        self._resumed = True
        return True

    def _generator_state(self):
        """The sampling generator's state as JSON-ready ints."""
        return self.generator.get_state().tolist()

    def _set_generator_state(self, state) -> None:
        self.generator.set_state(torch.tensor(state, dtype=torch.uint8))

    def set_components(self, components: Dict) -> None:
        """Restored ``params`` and ``opt_state`` are copied INTO the
        trainer's own tensors, so every holder of them (the leaf lists of
        ``train_step``, the reference branch, the target heads) trains on
        the restored values; a reward model's deep copy does not follow.
        Subclasses restore their ``state``."""
        copy_into(self.params, components["params"])
        copy_into(self.opt_state, components["opt_state"])

    @abstractmethod
    def act(self, prompts):
        raise NotImplementedError

    @abstractmethod
    def sample(self, prompts, length: int, n_samples: int):
        raise NotImplementedError

    @abstractmethod
    def learn(self, log_fn: Callable = None, save_fn: Callable = None,
              eval_fn: Callable = None):
        raise NotImplementedError

    @abstractmethod
    def get_components(self) -> Dict:
        raise NotImplementedError
