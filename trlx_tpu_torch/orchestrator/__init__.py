"""Orchestrator base and registry (port of trlx_tpu.orchestrator): an
orchestrator binds a prompt pipeline to an RL trainer and fills the
trainer's rollout store through ``make_experience``."""

from abc import abstractmethod
from typing import Dict

from trlx_tpu_torch.utils.registry import BuiltinLoader, make_register

_ORCH: Dict[str, type] = {}
_load_builtins = BuiltinLoader((
    "trlx_tpu_torch.orchestrator.ppo_orchestrator",
    "trlx_tpu_torch.orchestrator.offline_orchestrator",
))

#: Decorator registering an orchestrator class under a string name.
register_orchestrator = make_register(_ORCH)


class Orchestrator:
    """Binds (pipeline, rl_trainer); fills the trainer's store."""

    def __init__(self, pipeline, rl_model):
        self.pipeline = pipeline
        self.rl_model = rl_model

    @abstractmethod
    def make_experience(self, num_rollouts: int = 128, iter_count: int = 0):
        raise NotImplementedError
