"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``trlx_tpu_torch/csrc/<name>.cu`` with a plain
C entry point, compiled by ``nvcc`` for ``sm_90a`` into a shared library
and bound with ``ctypes`` (seconds to build; no PyTorch headers). The
build happens at first use, into ``build/kernels/`` at the repository
root (git-ignored), from the repository's own sources only. A library's
file name carries a hash of its source, of every header beside it
(``csrc/*.cuh``, which the wgmma kernels share) and of the flags, so an
edited source or header is never served by a stale build. Nothing here
runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

from trlx_tpu_torch.supervisor import monotonic

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: every kernel source of the port (csrc/<name>.cu)
KERNELS: Tuple[str, ...] = ("paged_decode", "flash_attention",
                            "flash_forward", "flash_backward")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build wall time (0.0 = reused), "log": nvcc output}
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and PATH): the port's CUDA kernels are "
            "compiled at first use and need the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.name.encode() + h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Dict[str, object]]:
    """Compile every named kernel that has no current build, all ``nvcc``
    processes started together; raises with the compiler's output if
    any build fails. Returns ``BUILD_INFO`` for the names."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        start = monotonic()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, proc, start))
    failures = []
    for name, out, tmp, proc, start in procs:
        log, _ = proc.communicate()
        seconds = monotonic() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: no concurrent build sees half a file
        BUILD_INFO[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {n: BUILD_INFO[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
