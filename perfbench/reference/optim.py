"""AdamW with clipping by the global gradient norm, written out: the
update that the configurations state (train.grad_clip, weight_decay,
learning rate; betas 0.9 / 0.999, eps 1e-8, the decay decoupled)."""

from typing import Dict, List

import torch


class AdamW:
    def __init__(self, params: List[torch.Tensor], max_norm: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = params
        self.max_norm, self.wd = max_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """One update; returns the clipped gradients it applied."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        factor = 1.0 if norm < self.max_norm else self.max_norm / norm
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        clipped = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = (g.double() * factor).float()
            clipped.append(g)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (m / c1) / (torch.sqrt(v / c2) + self.eps) \
                + self.wd * p
            p.sub_(lr * update)
        return clipped


def ramp_lr(count: int, ramp_steps: int, lr_init: float) -> float:
    """Linear warm-up from 0 over ``ramp_steps`` (the learning rate of
    the update made at ``count`` updates done), while it lasts."""
    if count >= ramp_steps:
        raise ValueError("only the warm-up is written out")
    return lr_init * count / max(ramp_steps, 1)


def leaf_gaps(ours: Dict[str, float], ref: Dict[str, float],
              skip=()) -> Dict[str, float]:
    """Per leaf, |norm(ours) - norm(ref)| over the larger of the leaf's
    reference norm and the median leaf's: the gap between the norms, not
    the norm of the difference, so an all-but-zero leaf does not blow
    up. ``skip``: leaves left out."""
    names = [n for n in ref if n not in skip]
    norms = sorted(ref[n] for n in names)
    median = norms[len(norms) // 2] if norms else 0.0
    return {n: abs(ours[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in names}


def small_gradient_leaves(grad_norms: Dict[str, float],
                          share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is nought to rounding: under
    ``share`` of the median leaf's (a key's bias under softmax). Adam
    moves them by round-off alone, so their change is not compared."""
    norms = sorted(grad_norms.values())
    median = norms[len(norms) // 2]
    return [n for n, g in grad_norms.items() if g < share * median]


def loss_gap(ours: List[float], ref: List[float]) -> float:
    """The largest gap between the two sides' losses of one update, over
    the largest reference loss of the updates compared (a loss that
    crosses 0 on one update would make a gap relative to itself
    meaningless)."""
    scale = max(abs(x) for x in ref)
    return max(abs(a - b) for a, b in zip(ours, ref)) / max(scale, 1e-30)
