"""Native (C++) host-runtime components, bound via ctypes (the port of
trlx_tpu.native).

The device path is the port's CUDA kernels; this package natively
implements the HOST side of the data path — the role torch's C++
DataLoader workers and HF's Rust tokenizers play in the reference's
stack (SURVEY §2.9):

- ``byte_tokenize_pad``: threaded UTF-8 byte tokenization with left/right
  padding (the ByteTokenizer hot path for large prompt sets);
- ``pad_collate``: threaded right-pad collation of variable-length token /
  mask / reward rows (the offline-store loader hot loop).

``trlx_tpu_torch/csrc/hostdata.cpp`` is compiled at first use with the
system C++ compiler (``g++ -O3 -std=c++17 -shared -fPIC -pthread``) into
``$TRLX_TPU_NATIVE_CACHE`` when that is set (trlx_tpu's variable, so a
read-only checkout can build elsewhere), else into ``build/host/`` at
the repository root (git-ignored, beside ``ops._build``'s
``build/kernels/``); the library's file name carries a hash of its
source and flags, and it is published by an atomic rename.
No pybind11: plain ``extern "C"`` + ctypes. Everything degrades to the
pure-Python implementations when no compiler is available or
``$TRLX_TPU_NO_NATIVE`` is set: :func:`available` gates every call site,
and the answers are the same either way. Nothing here builds at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from trlx_tpu_torch.supervisor import monotonic

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "hostdata.cpp"
#: where the library builds when ``$TRLX_TPU_NATIVE_CACHE`` is unset
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
#: names the build directory when set (trlx_tpu.native's variable)
CACHE_ENV = "TRLX_TPU_NATIVE_CACHE"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

#: calls that ran in the library, per function (the card smoke test reads
#: these to show the data path went through it)
CALLS: Dict[str, int] = {"byte_tokenize_pad": 0, "pad_collate": 0}
#: the last build: {"seconds": compile wall time (0.0 = reused), "path"}
BUILD_INFO: Dict[str, object] = {}

_lock = threading.Lock()
_lib = None
_tried = False


def compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")


def build_dir() -> Path:
    """``$TRLX_TPU_NATIVE_CACHE`` when set, else :data:`BUILD_DIR`."""
    cache = os.environ.get(CACHE_ENV)
    return Path(cache) if cache else BUILD_DIR


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"libhostdata-{digest}.so"


def _compile(cxx: str, path: Path) -> bool:
    # a unique tmp per process: concurrent first-use builds (pytest
    # workers) must not interleave writes into one file
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
    start = monotonic()
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic publish
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    BUILD_INFO.update(seconds=monotonic() - start, path=str(path))
    return True


def _build() -> Optional[ctypes.CDLL]:
    cxx = compiler()
    if cxx is None or not SOURCE.exists():
        return None
    so = library_path()
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    if so.exists():
        BUILD_INFO.update(seconds=0.0, path=str(so))
    elif not _compile(cxx, so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        # a corrupt cached artifact must not permanently disable the
        # native path — rebuild once
        so.unlink(missing_ok=True)
        if not _compile(cxx, so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    charpp = ctypes.POINTER(ctypes.c_char_p)
    lib.td_byte_tokenize_pad.argtypes = [
        charpp, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, i32p, i32p,
    ]
    lib.td_byte_tokenize_pad.restype = None
    lib.td_pad_collate.argtypes = [
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(f32p),
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
        i32p, i32p, f32p,
    ]
    lib.td_pad_collate.restype = None
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("TRLX_TPU_NO_NATIVE"):
                _lib = None
            else:
                _lib = _build()
        return _lib


def available() -> bool:
    """True when the native library compiled/loaded on this machine."""
    return _get() is not None


def byte_tokenize_pad(texts, max_len: int, pad_id: int,
                      pad_left: bool = True, threads: int = 0):
    """UTF-8 byte tokenization of `texts` padded/truncated to `max_len`.
    Returns (ids [n, max_len] int32, mask [n, max_len] int32)."""
    lib = _get()
    assert lib is not None, "native hostdata unavailable (check available())"
    raw = [t.encode("utf-8") for t in texts]
    n = len(raw)
    arr = (ctypes.c_char_p * n)(*raw)
    lens = np.asarray([len(r) for r in raw], np.int64)
    ids = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.int32)
    lib.td_byte_tokenize_pad(
        arr, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, max_len, pad_id, int(pad_left), threads,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    CALLS["byte_tokenize_pad"] += 1
    return ids, mask


def pad_collate(rows, masks, rewards, max_len: int, pad_id: int,
                threads: int = 0):
    """Right-pad collation of variable-length rows.

    rows: list of int32 arrays; masks: list of int32 arrays or None;
    rewards: list of float32 arrays (len-1 each) or None. Returns
    (ids [n, max_len], mask [n, max_len], rewards [n, max_len-1] | None).
    """
    lib = _get()
    assert lib is not None, "native hostdata unavailable (check available())"
    n = len(rows)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)

    rows = [np.ascontiguousarray(r, np.int32) for r in rows]
    row_ptrs = (i32p * n)(*[r.ctypes.data_as(i32p) for r in rows])
    lens = np.asarray([len(r) for r in rows], np.int64)

    if masks is not None:
        masks = [np.ascontiguousarray(m, np.int32) for m in masks]
        for i, (r, m) in enumerate(zip(rows, masks)):
            if len(m) != len(r):  # the C side memcpy's len(row) elements —
                raise ValueError(  # a short row would be an OOB heap read
                    f"mask row {i} has length {len(m)}, expected {len(r)}"
                )
        mask_ptrs = (i32p * n)(*[m.ctypes.data_as(i32p) for m in masks])
    else:
        mask_ptrs = ctypes.cast(None, ctypes.POINTER(i32p))

    out_rewards = None
    if rewards is not None:
        rewards = [np.ascontiguousarray(r, np.float32) for r in rewards]
        for i, (r, rw) in enumerate(zip(rows, rewards)):
            if len(r) > 1 and len(rw) != len(r) - 1:
                raise ValueError(
                    f"rewards row {i} has length {len(rw)}, expected "
                    f"{len(r) - 1} (one per transition)"
                )
        reward_ptrs = (f32p * n)(*[r.ctypes.data_as(f32p) for r in rewards])
        out_rewards = np.empty((n, max_len - 1), np.float32)
        out_rw_ptr = out_rewards.ctypes.data_as(f32p)
    else:
        reward_ptrs = ctypes.cast(None, ctypes.POINTER(f32p))
        out_rw_ptr = ctypes.cast(None, f32p)

    ids = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.int32)
    lib.td_pad_collate(
        row_ptrs, mask_ptrs, reward_ptrs,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, max_len, pad_id, threads,
        ids.ctypes.data_as(i32p), mask.ctypes.data_as(i32p), out_rw_ptr,
    )
    CALLS["pad_collate"] += 1
    return ids, mask, out_rewards
