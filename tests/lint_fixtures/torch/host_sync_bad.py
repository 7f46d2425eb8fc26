import torch

from trlx_tpu_torch.utils.aotjit import aot_jit


def _step(x, n):
    total = float(x.sum())
    if x.max().item() > n:
        torch.cuda.synchronize()
    return x * total + len(x.tolist())


class Runner:
    def __init__(self):
        self.step = aot_jit(_step)


@aot_jit
def to_host(x):
    return x.cpu().numpy()
