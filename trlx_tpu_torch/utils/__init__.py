"""Host utilities shared by the port (``resolve_device``, ``DTYPES``)
and the copies of trlx_tpu.utils the trainers need: ``flatten``,
``chunk``, ``rampup_decay_schedule``, ``cosine_schedule``,
``tree_bytes`` and ``Clock``."""

import math
import time
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU explicitly. With no card and no explicit ``"cpu"`` this
    raises — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}' (cuda or cpu)")
    return dev


DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def flatten(xs: Iterable[Iterable[Any]]) -> List[Any]:
    """Flatten one level of nesting."""
    return [item for sub in xs for item in sub]


def chunk(xs: List[Any], chunk_size: int) -> List[List[Any]]:
    """Split a list into chunks of at most ``chunk_size``."""
    return [xs[i:i + chunk_size] for i in range(0, len(xs), chunk_size)]


def _linear(init: float, end: float, steps: int, step: int) -> float:
    """optax's ``linear_schedule(init, end, steps)`` at ``step``, in
    float32 as optax computes it."""
    f32 = np.float32
    frac = f32(1) - f32(min(max(step, 0), steps)) / f32(steps)
    return float(f32(init - end) * frac + f32(end))


def rampup_decay_schedule(ramp_steps: int, decay_steps: int, lr_init: float,
                          lr_target: float) -> Callable[[int], float]:
    """``step -> lr``: linear warmup from 0 to ``lr_init`` over
    ``ramp_steps``, then linear decay to ``lr_target`` over
    ``decay_steps``, with optax's ``join_schedules`` semantics (each
    length at least 1; the second piece reads ``step - ramp_steps``).
    The lr is 0 at step 0."""
    ramp, decay = max(ramp_steps, 1), max(decay_steps, 1)

    def schedule(step: int) -> float:
        if step < ramp:
            return _linear(0.0, lr_init, ramp, step)
        return _linear(lr_init, lr_target, decay, step - ramp)

    return schedule


def tree_bytes(tree) -> int:
    """Total bytes of the numpy leaves of nested dicts, tuples, lists and
    batch dataclasses."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(tree_bytes(getattr(tree, k))
                   for k in tree.__dataclass_fields__)
    return int(np.asarray(tree).nbytes)


def cosine_schedule(lr_init: float, total_steps: int,
                    lr_min: float = 1e-9) -> Callable[[int], float]:
    """``step -> lr`` cosine annealing from ``lr_init`` to ``lr_min`` over
    ``total_steps``, with optax's ``cosine_decay_schedule`` semantics:
    the step is clamped to the decay length, and the multiplier is
    ``(1 - alpha) * 0.5 * (1 + cos(pi * t / T)) + alpha`` with
    ``alpha = lr_min / lr_init``."""
    decay_steps = float(max(total_steps, 1))
    alpha = lr_min / max(lr_init, 1e-30)

    def schedule(step: int) -> float:
        t = min(float(step), decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return lr_init * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Clock:
    """Wall time and throughput: ``tick(samples)`` records a mark;
    elapsed time counts toward throughput only when samples were
    processed, so a bare ``tick()`` excludes idle or set-up time."""

    def __init__(self):
        self.start = time.time()
        self.total_seconds = 0.0
        self.total_samples = 0

    def tick(self, samples: int = 0) -> float:
        now = time.time()
        delta = now - self.start
        self.start = now
        if samples:
            self.total_seconds += delta
            self.total_samples += samples
        return delta

    def get_stat(self, n_samp: int = 1000, reset: bool = False) -> float:
        """Average seconds per ``n_samp`` samples."""
        sec_per_samp = self.total_seconds / max(self.total_samples, 1)
        if reset:
            self.total_seconds = 0.0
            self.total_samples = 0
        return sec_per_samp * n_samp

    def samples_per_second(self) -> float:
        return self.total_samples / max(self.total_seconds, 1e-9)
