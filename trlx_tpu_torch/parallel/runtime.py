"""Multi-process runtime bootstrap (port of trlx_tpu.parallel.runtime).

One process per card, as ``torchrun --nproc_per_node N`` starts them:
:func:`initialize_runtime` joins them into one ``torch.distributed``
process group, NCCL on ``cuda:LOCAL_RANK`` (gloo when the caller asks
for the CPU). In one process that was not started by torchrun it does
nothing, so it is safe to call unconditionally; it is idempotent.
Nothing falls back: asking for more processes on a host than it has
cards raises here.
"""

import os
import socket
from typing import Optional

import numpy as np
import torch


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _device_type(device_type: Optional[str]) -> str:
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type '{device_type}' "
                         f"(cuda or cpu)")
    return device_type


def _bind_card(local_rank: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' to run "
            "the process group over gloo on the CPU")
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"process with local rank {local_rank} has no card: this host "
            f"has {count}; start at most {count} processes per host")
    torch.cuda.set_device(local_rank)


def initialize_runtime(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       device_type: Optional[str] = None) -> None:
    """Join the world's processes into one process group.

    With no arguments it reads torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and is a
    no-op when ``WORLD_SIZE`` is unset or 1. Explicit arguments
    (``init_method`` such as ``tcp://localhost:<port>``, the world size
    and this process's rank) support rigs without torchrun. The backend
    is NCCL on ``cuda:LOCAL_RANK`` (``device_type`` "cuda", the default)
    or gloo (``device_type`` "cpu")."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    explicit = init_method is not None
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and env_world <= 1:
        return
    device_type = _device_type(device_type)
    world_size = env_world if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    if device_type == "cuda":
        _bind_card(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(_backend(device_type),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def ensure_process_group(device_type: Optional[str] = None) -> str:
    """The device type of the world's process group, starting one first
    when there is none: torchrun's world when its environment is set,
    else a world of this one process on a free localhost port (the mesh
    code path on one card). A group of the other kind raises."""
    import torch.distributed as dist

    device_type = _device_type(device_type)
    if not dist.is_initialized():
        initialize_runtime(device_type=device_type)
    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        initialize_runtime(f"tcp://127.0.0.1:{port}", 1, 0, device_type)
    backend = dist.get_backend()
    if backend != _backend(device_type):
        raise ValueError(f"the process group runs {backend}, which does "
                         f"not serve device type '{device_type}'")
    return device_type


def process_count() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """Rank 0 of the default ``torch.distributed`` group, or True when
    none is initialised: the one process that writes run artifacts and
    emits metrics (the reference's ``accelerator.is_main_process``)."""
    return process_index() == 0


def broadcast_host_floats(values) -> np.ndarray:
    """Process 0's view of a host-computed float array, identical on
    every process; the identity in one process.

    Replicated loading (trlx_tpu_torch.parallel.sharding.shard_batch)
    requires every process to hold bit-identical global batches. Prompts
    are seed-deterministic, but a host ``reward_fn`` (an HF pipeline, a
    service call) need not answer bit-identically on every process, and
    its rewards feed the shards: broadcasting process 0's closes that
    hole (the reference's per-rank loader split + gather)."""
    import torch.distributed as dist

    arr = np.asarray(values, np.float32)
    if process_count() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
