import torch

from trlx_tpu_torch.ops import count_launch


def fixture_kernel(x):
    if x.device.type != "cuda":
        return torch.relu(x)
    count_launch("fixture_kernel")
    return torch.relu(x)
