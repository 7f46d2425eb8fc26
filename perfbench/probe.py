"""What the benchmark reads of the program while it runs: the first
updates of a trainer (losses, the first gradient as the optimizer got
it, the change of every leaf), and the shapes of the attention calls a
traced part of the window makes. Nothing here changes what the program
computes."""

import contextlib
from typing import Dict, List, Tuple

import torch


def port_spec(spec):
    """The program's ``ModelSpec`` of a configuration's ``spec`` block."""
    from trlx_tpu_torch.data.configs import ModelSpec

    return ModelSpec(**spec)


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += named_leaves(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


class TrainProbe:
    """Wraps ``trainer.train_step`` for the first ``steps`` updates and
    records: each update's loss and batch, the norm of every leaf's first
    gradient as the optimizer got it (AdamW's first moment after one
    update over 1 - beta1), and the norm of every leaf's change over the
    ``steps`` updates. The wrapper removes itself after the last."""

    def __init__(self, trainer, steps: int = 3, b1: float = 0.9):
        self.trainer, self.steps, self.b1 = trainer, steps, b1
        self.losses: List[float] = []
        self.batches: List = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self._start = None
        self._inner = trainer.train_step
        trainer.train_step = self._step

    def _leaves(self):
        return named_leaves(self.trainer.params["trainable"])

    def _step(self, batch):
        if not self.losses:
            self._start = [p.detach().clone() for _, p in self._leaves()]
        self.batches.append(batch)
        stats = self._inner(batch)
        self.losses.append(float(stats["loss"]))
        if len(self.losses) == 1:
            mu = self.trainer.opt_state["mu"]
            self.grad = {n: float(m.double().norm()) / (1 - self.b1)
                         for (n, _), m in zip(self._leaves(), mu)}
        if len(self.losses) == self.steps:
            self.change = {n: float((p.detach() - p0).double().norm())
                           for (n, p), p0 in zip(self._leaves(),
                                                 self._start)}
            self._start = None
            del self.trainer.train_step  # back to the class's method
        return stats


class FlashCalls:
    """The shapes and masks of the flash kernels' calls while
    :meth:`recording` (each wrapper of ``trlx_tpu_torch.ops.
    flash_attention`` is looked up by name when called, so wrapping the
    module's functions sees every call)."""

    NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def __init__(self):
        self.calls: List[tuple] = []

    @contextlib.contextmanager
    def recording(self):
        from trlx_tpu_torch.ops import flash_attention as fa

        saved = {n: getattr(fa, n) for n in self.NAMES}

        def wrap(name, fn):
            def call(q, k, v, *rest, **kw):
                causal = kw.get("causal", rest[-1] if rest and isinstance(
                    rest[-1], bool) else True)
                mask = next(t for t in rest if torch.is_tensor(t)
                            and t.dim() == 2)
                self.calls.append((name, tuple(q.shape), q.element_size(),
                                   bool(causal), mask))
                return fn(q, k, v, *rest, **kw)
            return call

        for n, fn in saved.items():
            setattr(fa, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(fa, n, fn)
