"""RL trainer base and registry (port of trlx_tpu.trainers).

The abstract surface (``act`` / ``sample`` / ``learn`` /
``get_components`` / ``intervals`` / ``push_to_store``) is trlx_tpu's;
parameters and optimizer state are tensors the trainer holds and
updates in place on its device. :func:`build_optimizer` is optax's
``chain(clip_by_global_norm, adamw)`` with a schedule, written out; both
trainers build theirs with it.

Not ported yet, and refused at construction with a clear error: a mesh
other than all ones (and ``sp`` / ``pp``), ``max_bad_steps > 0`` (the
StepGuard and the commit gate), ``continuous_rollouts`` and
``resume_from`` (checkpoints).
"""

from abc import abstractmethod
from typing import Callable, Dict, List

import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.utils import DTYPES, cosine_schedule, resolve_device
from trlx_tpu_torch.utils.registry import BuiltinLoader, make_register

_TRAINERS: Dict[str, type] = {}
_load_builtins = BuiltinLoader(("trlx_tpu_torch.trainers.ppo_trainer",
                                "trlx_tpu_torch.trainers.ilql_trainer"))

#: Decorator registering a trainer class under a string name.
register_trainer = make_register(_TRAINERS)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to trlx_tpu_torch yet")


def check_ported(config, mesh=None) -> None:
    """Raise for the configuration knobs this port does not run yet."""
    t = config.train
    if mesh is not None:
        raise _not_ported("an explicit device mesh")
    for axis, size in (t.mesh or {}).items():
        if size not in (1, -1):  # -1 = every device: one here
            raise _not_ported(f"train.mesh {axis}={size} (only a "
                              f"single-device mesh runs)")
    if getattr(t, "max_bad_steps", 0) > 0:
        raise _not_ported("train.max_bad_steps > 0 (the StepGuard and "
                          "the commit gate)")
    if getattr(t, "continuous_rollouts", False):
        raise _not_ported("train.continuous_rollouts")
    if getattr(t, "resume_from", ""):
        raise _not_ported("train.resume_from (checkpoints)")


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    tree_map(out.append, tree)
    return out


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
    """

    def __init__(self, schedule: Callable[[int], float], max_norm: float,
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
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
        }

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict) -> torch.Tensor:
        """One update of ``params`` in place; returns the pre-clip global
        gradient norm."""
        g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = g_norm < self.max_norm
        count = state["count"] + 1
        dev = g_norm.device
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        bc1 = 1 - f32(self.b1) ** count
        bc2 = 1 - f32(self.b2) ** count
        lr = f32(self.schedule(state["count"]))
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            # b1 * mu in the moment's own dtype, b1 rounded to it first,
            # as optax's weak-typed scalar times a bfloat16 moment is
            mu_prev = state["mu"][i]
            mu = (1 - self.b1) * g + mu_prev * torch.tensor(
                self.b1, dtype=mu_prev.dtype, device=dev)
            nu = (1 - self.b2) * g * g + self.b2 * state["nu"][i]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(-lr * update)
            state["mu"][i] = mu.to(self.mu_dtype)
            state["nu"][i] = nu
        state["count"] = count
        return g_norm


def build_optimizer(train_config, sched=None) -> AdamW:
    """Grad clip + AdamW + LR schedule (default: cosine anneal from
    ``learning_rate_init`` to ``learning_rate_target`` over
    ``total_steps``), as trlx_tpu builds it with optax."""
    if sched is None:
        sched = cosine_schedule(train_config.learning_rate_init,
                                train_config.total_steps,
                                lr_min=train_config.learning_rate_target)
    name = getattr(train_config, "optimizer", "adamw").lower()
    if name == "adafactor":
        raise NotImplementedError(
            "train.optimizer 'adafactor' is not ported to trlx_tpu_torch yet")
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
        if config.train.telemetry:
            telemetry.start()

    def _put(self, tree):
        """Host tensors (or a tree of them) -> the trainer's device."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)

    def _sync(self) -> None:
        """Wait for the device (host spans then time device work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_attention_fn(self):
        """Attention for train-time forwards: the flash kernels when
        ``model.fused_attention`` is true (sequences shorter than the
        seam's ``_MIN_FUSED_T`` take the dense path, as forced runs of
        the JAX package do); else None = dense attention. The JAX package
        also turns the kernel on by itself at T >= 1024 on a TPU — a
        threshold measured on a TPU; the port sets its own from H100
        measurements in a later change, and until then only an explicit
        ``fused_attention: true`` selects the kernels. Generation keeps
        the dense KV-cache decode either way."""
        if self.config.model.fused_attention:
            from trlx_tpu_torch.ops.flash_attention import (
                make_flash_attention_fn,
            )

            return make_flash_attention_fn()
        return None

    def _telemetry_stats(self) -> Dict[str, float]:
        """Seconds spent so far in each span (``time/<name>``)."""
        session = telemetry.current()
        if session is None:
            return {}
        return {name: h.total for name, h in session.registry.hists.items()}

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

    def save(self, directory: str = None) -> None:
        raise _not_ported("save() (checkpoints)")

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
