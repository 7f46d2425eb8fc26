"""Host utilities shared by the port."""

from typing import Optional

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
