"""RL trainer base and registry (port of trlx_tpu.trainers).

The abstract surface (``act`` / ``sample`` / ``learn`` /
``get_components`` / ``intervals`` / ``push_to_store``) is trlx_tpu's;
parameters and optimizer state are tensors the trainer holds and
updates in place on its device.

Not ported yet, and refused at construction with a clear error: a mesh
other than all ones (and ``sp`` / ``pp``), ``max_bad_steps > 0`` (the
StepGuard and the commit gate), ``continuous_rollouts`` and
``resume_from`` (checkpoints).
"""

from abc import abstractmethod
from typing import Callable, Dict

import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.utils import resolve_device
from trlx_tpu_torch.utils.registry import BuiltinLoader, make_register

_TRAINERS: Dict[str, type] = {}
_load_builtins = BuiltinLoader(("trlx_tpu_torch.trainers.ppo_trainer",))

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
