"""Typed configuration and the PPO rollout containers (port of
trlx_tpu.data; ``ppo_types`` is imported from its own module)."""

from trlx_tpu_torch.data.configs import (  # noqa: F401
    ModelConfig,
    ModelSpec,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.data.method_configs import (  # noqa: F401
    ILQLConfig,
    MethodConfig,
    PPOConfig,
    filter_known_fields,
    get_method,
)
