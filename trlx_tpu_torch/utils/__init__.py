"""Host utilities shared by the port (``resolve_device``, ``DTYPES``,
``is_main_process``)
and the copies of trlx_tpu.utils the trainers need: ``flatten``,
``chunk``, ``rampup_decay_schedule``, ``cosine_schedule``,
``tree_bytes`` and ``Clock``.

The two schedules take the optimizer's step count as a 0-d int32 tensor
on the trainer's device and return a 0-d float32 tensor there, with no
host sync (a step the commit gate skips leaves the count, and so the
learning rate, where it was); called with a Python int they return the
same value as a float. Each computes what the reference's compiled
optax schedule computes, bit for bit: XLA turns ``(pi * t) / T`` and
``t / steps`` into products with one folded float32 constant, fuses
each ``a * x + b`` into one rounding, and takes the C library's float32
cosine (:func:`cosf`).
"""

import math
import time
from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch

# the main-process gate lives with the runtime; re-exported for the
# trackers, telemetry and the checkpoint gate
from trlx_tpu_torch.parallel.runtime import is_main_process  # noqa: F401


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


def _f32(x) -> float:
    """``x`` rounded to float32 (as a Python float)."""
    return float(np.float32(x))


def _fma32(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """float32 ``x * a + b`` rounded once, as XLA's fused multiply-add
    gives it: the product of two float32 values is exact in float64."""
    return (x.double() * a + b).float()


def _schedule(fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` (int32 step tensor -> float32 tensor) that also takes a
    Python int and then returns a float."""

    def schedule(step):
        if torch.is_tensor(step):
            return fn(step)
        return float(fn(torch.tensor(int(step), dtype=torch.int32)))

    return schedule


def _linear(init: float, end: float, steps: int):
    """optax's ``linear_schedule(init, end, steps)`` as XLA compiles it:
    ``frac = 1 - clip(t, 0, steps) * f32(1 / steps)`` rounded once, and
    ``(frac * f32(init - end), f32(end))`` for the caller to add."""
    inv = _f32(np.float32(1) / np.float32(steps))
    scale, offset = _f32(init - end), _f32(end)

    def fn(step: torch.Tensor):
        frac = _fma32(-step.clamp(0, steps).float(), inv, 1.0)
        return frac, scale, offset

    return fn


def rampup_decay_schedule(ramp_steps: int, decay_steps: int, lr_init: float,
                          lr_target: float):
    """``step -> lr``: linear warmup from 0 to ``lr_init`` over
    ``ramp_steps``, then linear decay to ``lr_target`` over
    ``decay_steps``, with optax's ``join_schedules`` semantics (each
    length at least 1; the second piece reads ``step - ramp_steps``).
    The lr is 0 at step 0. Each piece's ``frac * scale + offset`` is
    rounded once; when both pieces end in the same offset
    (``lr_target == lr_init``) XLA adds it once after the select,
    unfused, and so does this."""
    ramp, decay = max(ramp_steps, 1), max(decay_steps, 1)
    up = _linear(0.0, lr_init, ramp)
    down = _linear(lr_init, lr_target, decay)
    shared = _f32(lr_init) == _f32(lr_target)

    def fn(step: torch.Tensor) -> torch.Tensor:
        pieces = (up(step), down(step - ramp))
        if shared:
            (f1, s1, offset), (f2, s2, _) = pieces
            return torch.where(step < ramp, f1 * s1, f2 * s2) + offset
        first, second = (_fma32(*piece) for piece in pieces)
        return torch.where(step < ramp, first, second)

    return _schedule(fn)


#: the float32 cosine's constants (below): 2 / pi scaled by 2^24, pi / 2,
#: and the cosine and sine polynomials on [-pi/4, pi/4]
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p0")
_COS_POLY = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def cosf(y: torch.Tensor) -> torch.Tensor:
    """The float32 cosine of a float32 tensor with values in [0, 120),
    bit for bit the GNU C library's ``cosf``
    (``sysdeps/ieee754/flt-32/s_cosf.c``), which XLA's CPU backend calls
    for the reference's schedule: the argument is reduced by the nearest
    multiple n of pi/2 in float64, then the cosine (n even) or sine (n
    odd) polynomial runs in float64 with the quadrant's sign, and the
    result is rounded once to float32. Written as float64 torch ops, each
    rounded on its own, so the CPU and the card give the same bits."""
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    r = x - n.double() * _HPI
    x2 = r * r
    c0, c1, c2, c3, c4 = _COS_POLY
    x4 = x2 * x2
    cos = (c0 + x2 * c1) + x4 * c2 + (x4 * x2) * (c3 + x2 * c4)
    cos = torch.where((n & 2) == 0, cos, -cos)
    rs = torch.where(((n & 3) == 1) | ((n & 3) == 2), -r, r)
    s1, s2, s3 = _SIN_POLY
    x3 = rs * x2
    sin = (rs + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    out = torch.where((n & 1) == 0, cos, sin).float()
    return torch.where(y < 2.0 ** -12, torch.ones_like(out), out)


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
                    lr_min: float = 1e-9):
    """``step -> lr`` cosine annealing from ``lr_init`` to ``lr_min`` over
    ``total_steps``, with optax's ``cosine_decay_schedule`` semantics:
    the step is clamped to the decay length, and the multiplier is
    ``(1 - alpha) * 0.5 * (1 + cos(pi * t / T)) + alpha`` with
    ``alpha = lr_min / lr_init``, in float32 as XLA compiles it."""
    steps = max(total_steps, 1)
    alpha = lr_min / max(lr_init, 1e-30)
    # XLA turns ``/ T`` into ``* f32(1 / T)`` and folds pi into it
    arg = _f32(np.float32(math.pi) * (np.float32(1) / np.float32(steps)))
    half_span, floor, lr = _f32(0.5 * _f32(1.0 - alpha)), _f32(alpha), \
        _f32(lr_init)

    def fn(step: torch.Tensor) -> torch.Tensor:
        t = step.float().clamp(max=float(steps))
        return _fma32(cosf(t * arg) + 1, half_span, floor) * lr

    return _schedule(fn)


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
