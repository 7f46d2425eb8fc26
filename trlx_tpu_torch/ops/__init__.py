"""Kernels of the port and their launch counters.

Every wrapper of a hand-written kernel adds one to its entry in
:data:`LAUNCHES` where it launches the kernel on the card, and nowhere
else (its plain-PyTorch CPU path does not count), so a run can show
that its main path went through the kernel.

Under CUDA-graph capture (trlx_tpu_torch.utils.aotjit) a wrapper's
launch is only recorded: :func:`recording_launches` collects it on the
capturing thread, and each replay of the graph adds the record with
:func:`add_launches`. So :data:`LAUNCHES` counts kernels that ran on
either path.
"""

import contextlib
import threading
from typing import Dict

#: kernel name -> launches on the card since import or the last reset
LAUNCHES: Dict[str, int] = {
    "paged_decode": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
}

_launch_lock = threading.Lock()
_capturing = threading.local()


def count_launch(name: str) -> None:
    record = getattr(_capturing, "record", None)
    if record is not None:
        record[name] = record.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


def add_launches(record: Dict[str, int]) -> None:
    """Count the launches of one graph replay."""
    with _launch_lock:
        for name, n in record.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def recording_launches():
    """On this thread, record launches instead of counting them (a
    capture enqueues nothing); yields the record, name -> launches."""
    record: Dict[str, int] = {}
    _capturing.record = record
    try:
        yield record
    finally:
        _capturing.record = None


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


# sequence and pipeline parallelism: no kernel of their own, they run the
# flash kernels block by block and stage by stage (the mesh entry
# ring_attention stays in its module: exported here, the function would
# hide the module of the same name)
from trlx_tpu_torch.ops.pipeline_parallel import (  # noqa: E402,F401
    pp_apply_blocks,
    pp_apply_blocks_loopback,
    shard_blocks_pp,
)
from trlx_tpu_torch.ops.ring_attention import (  # noqa: E402,F401
    SequenceSplit,
    make_sp_attention_fn,
    ring_attention_loopback,
)
