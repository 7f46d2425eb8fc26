"""Per-algorithm hyperparameter configs, looked up by name from YAML.

JAX-free copy of trlx_tpu.data.method_configs: the same registry
contract (string-keyed, case-insensitive) and the same field sets, so a
YAML means the same thing to both packages.
"""

from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict

from trlx_tpu_torch.utils.registry import make_register

_METHODS: Dict[str, type] = {}

#: Decorator registering a method config class under a string name.
register_method = make_register(_METHODS)


def get_method(name: str) -> Callable:
    """Return the config class registered under `name`."""
    key = name.lower()
    if key not in _METHODS:
        raise KeyError(
            f"Method config '{name}' is not registered. "
            f"Known methods: {sorted(_METHODS)}"
        )
    return _METHODS[key]


def filter_known_fields(cls, config: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only keys that are dataclass fields of `cls` (tolerates legacy
    YAML keys like `device` / `accelerate`)."""
    known = {f.name for f in fields(cls)}
    return {k: v for k, v in config.items() if k in known}


@dataclass
@register_method
class MethodConfig:
    """Base config for an RL method; `name` selects the registry entry."""

    name: str

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**filter_known_fields(cls, config))


@dataclass
@register_method
class PPOConfig(MethodConfig):
    """PPO hyperparameters (field parity with trlx_tpu's PPOConfig)."""

    ppo_epochs: int = 4
    num_rollouts: int = 128
    chunk_size: int = 128
    init_kl_coef: float = 0.2
    target: float = 6.0
    horizon: int = 10000
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 1.0
    gen_kwargs: dict = field(default_factory=dict)


@dataclass
@register_method
class ILQLConfig(MethodConfig):
    """ILQL hyperparameters (field parity with trlx_tpu's ILQLConfig), read
    by trlx_tpu_torch.trainers.ilql_trainer."""

    tau: float = 0.7
    gamma: float = 0.99
    cql_scale: float = 0.1
    awac_scale: float = 1.0
    alpha: float = 1.0
    steps_for_target_q_sync: int = 10
    beta: float = 4.0
    two_qs: bool = True
    top_k: int = 20
    temperature: float = 1.0
