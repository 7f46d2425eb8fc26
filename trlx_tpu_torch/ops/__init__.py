"""Kernels of the port and their launch counters.

Every wrapper of a hand-written kernel adds one to its entry in
:data:`LAUNCHES` where it launches the kernel on the card, and nowhere
else (its plain-PyTorch CPU path does not count), so a run can show
that its main path went through the kernel.
"""

import threading
from typing import Dict

#: kernel name -> launches on the card since import or the last reset
LAUNCHES: Dict[str, int] = {
    "paged_decode": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
}

_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
