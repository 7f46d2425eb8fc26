"""KL-penalty coefficient controllers (copy of
trlx_tpu.trainers.kl_controllers; host-side state). The coefficient is a
scalar fed to each rollout chunk's scoring; its update is host math
driven by the measured mean KL."""

import numpy as np


class AdaptiveKLController:
    """Proportional controller toward a target KL (Ziegler et al. appendix);
    error clipped to ±0.2 per update
    (parity: reference accelerate_ppo_model.py:24-34)."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = float(init_kl_coef)
        self.target = float(target)
        self.horizon = int(horizon)

    def update(self, current_kl: float, n_steps: int) -> float:
        error = np.clip(current_kl / self.target - 1.0, -0.2, 0.2)
        self.value *= 1.0 + error * n_steps / self.horizon
        return self.value


class FixedKLController:
    """Constant coefficient (parity: reference accelerate_ppo_model.py:38-44)."""

    def __init__(self, kl_coef: float):
        self.value = float(kl_coef)

    def update(self, current_kl: float, n_steps: int) -> float:
        return self.value


def make_kl_controller(init_kl_coef: float, target, horizon: int):
    """Adaptive when a target is configured, fixed otherwise (parity:
    reference accelerate_ppo_model.py:52-59)."""
    if target is None or (isinstance(target, (int, float)) and target <= 0):
        return FixedKLController(init_kl_coef)
    return AdaptiveKLController(init_kl_coef, target, horizon)
