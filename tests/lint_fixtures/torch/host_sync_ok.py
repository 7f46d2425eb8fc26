import torch

from trlx_tpu_torch.utils.aotjit import aot_jit


def _step(x, n):
    scale = float(x.shape[0]) * int(x.size(1)) / x.numel()
    return torch.where(x > n, x * scale, x)


class Runner:
    def __init__(self):
        self.step = aot_jit(_step)

    def pull(self, x):
        out = self.step(x, 2)
        return float(out.sum().item()), out.cpu().tolist()

    def item(self):
        return 0
