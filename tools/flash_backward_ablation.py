"""Where the bf16 flash backward's time goes, on a card.

Builds copies of ``trlx_tpu_torch/csrc/flash_backward.cu`` (into
``build/kernels/ablation/``, git-ignored) with parts of
each kernel's tile loop taken out (their results are wrong: only their
times count) or with the grid in the head-minor order, and times dq and
dk/dv with CUDA events at the training shape (B 32, T 576, H 12, hd 64)
and at gpt-j-6B's (B 8, T 576, H 16, hd 256), causal, bf16. Prints one
line per variant and shape, then one JSON object with every time. Run
from the repository root on a machine with the card and nvcc::

    python3 tools/flash_backward_ablation.py

Variants: ``as built``; ``no second products`` (dq += dS K, dV and dK
gone); ``no softmax terms`` (P and dS replaced by the raw scores);
``no first products`` (S and dP left zero); ``data path only`` (all
three gone: the loads, barriers, D and the stores remain);
``head-minor grid`` (a head's blocks spread across the grid, as the
mma.sync kernels ordered them). Each variant edits an anchor line of the
source; a missing anchor raises rather than time the unchanged kernels.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from trlx_tpu_torch.ops import _build  # noqa: E402
from trlx_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC_DIR / "flash_backward.cu"

DQ_FIRST = "    first_products<HD>(s, dp, q_s, ks, g_s, v_s + st * G::TILE);"
DKV_FIRST = "    first_products<HD>(s, dp, k_s, qs, v_s, gs);"
NO_FIRST = ("    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;\n"
            "    keep(s);\n    keep(dp);")
DQ_SCORES = """    if (causal && jt == iq)
      dq_scores<true>(s, dp, ms, sl, lse2, d_r, row, tq, hi, lo);
    else
      dq_scores<false>(s, dp, ms, sl, lse2, d_r, row, tq, hi, lo);"""
DKV_SCORES = """    if (causal && it == jk)
      dkv_scores<true>(s, dp, ls, dd, sl, kb2, row, tq, pa, pl, dsa, dsl);
    else
      dkv_scores<false>(s, dp, ls, dd, sl, kb2, row, tq, pa, pl, dsa, dsl);"""
RAW_DQ = """    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) {
        hi[j][e] = __float_as_uint(s[j * 8 + e]);
        lo[j][e] = __float_as_uint(dp[j * 8 + e]);
      }"""
RAW_DKV = """    for (int j = 0; j < 4; ++j)
      for (int e = 0; e < 4; ++e) {
        pa[j][e] = __float_as_uint(s[j * 8 + e]);
        pl[j][e] = __float_as_uint(dp[j * 8 + e]);
        dsa[j][e] = __float_as_uint(s[j * 8 + e + 4]);
        dsl[j][e] = __float_as_uint(dp[j * 8 + e + 4]);
      }"""
SECOND = ("    // dq += dS K: K's rows", "    // dV += P^T dO and dK += dS^T Q")
DQ_ORDER = ("  const int bh = blockIdx.x / n_k;",
            "  const int iq = n_k - 1 - (blockIdx.x - bh * n_k);")
DQ_MINOR = ("  const int bh = blockIdx.x % (gridDim.x / n_k);",
            "  const int iq = n_k - 1 - blockIdx.x / (gridDim.x / n_k);")
DKV_ORDER = ("  const int bh = blockIdx.x / n_q;",
             "  const int jk = blockIdx.x - bh * n_q;")
DKV_MINOR = ("  const int bh = blockIdx.x % (gridDim.x / n_q);",
             "  const int jk = blockIdx.x / (gridDim.x / n_q);")

VARIANTS = ("as built", "no second products", "no softmax terms",
            "no first products", "data path only", "head-minor grid")


def replace(src, old, new):
    if old not in src:
        raise ValueError(f"anchor not in {SOURCE.name}: {old[:60]!r}")
    return src.replace(old, new)


def drop_second(src):
    """Remove each kernel's second products (from its comment to the
    wgmma commit that follows), keeping the fence, commit and wait."""
    for anchor in SECOND:
        a = src.index(anchor)
        b = src.index("    wg_commit();", a)
        src = src[:a] + "    wg_fence();\n" + src[b:]
    return src


def variant(name, src):
    if name in ("no first products", "data path only"):
        src = replace(src, DQ_FIRST, NO_FIRST)
        src = replace(src, DKV_FIRST, NO_FIRST)
    if name in ("no softmax terms", "data path only"):
        src = replace(src, DQ_SCORES, RAW_DQ)
        src = replace(src, DKV_SCORES, RAW_DKV)
    if name in ("no second products", "data path only"):
        src = drop_second(src)
    if name == "head-minor grid":
        for old, new in zip(DQ_ORDER + DKV_ORDER, DQ_MINOR + DKV_MINOR):
            src = replace(src, old, new)
    return src


def build(directory):
    """Every variant's library, all nvcc processes at once (the copies
    include csrc/hopper.cuh from the source directory)."""
    src = SOURCE.read_text()
    procs = []
    for i, name in enumerate(VARIANTS):
        cu = os.path.join(directory, f"v{i}.cu")
        so = os.path.join(directory, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(variant(name, src))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               "-I", str(_build.CSRC_DIR), "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(so)
    return libs


def bind(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_us(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def run(libs, B, T, H, hd):
    gen = torch.Generator(device="cuda").manual_seed(T + hd)
    q, k, v, g = (torch.randn((B, T, H, hd), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    o, lse = fa.flash_fwd(q, k, v, mask)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dD = torch.empty_like(lse)
    stream = torch.cuda.current_stream().cuda_stream
    scale = fa.flash_scale(hd)
    out = {}
    for name, lib in libs.items():
        dq_fn = bind(lib, "flash_bwd_dq_bf16")
        dkv_fn = bind(lib, "flash_bwd_dkv_bf16")

        def call_dq():
            return dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         g.data_ptr(), o.data_ptr(), lse.data_ptr(),
                         mask.data_ptr(), dq.data_ptr(), dD.data_ptr(), B,
                         T, H, hd, 1, scale, stream)

        def call_dkv():
            return dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          g.data_ptr(), lse.data_ptr(), dD.data_ptr(),
                          mask.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
                          T, H, hd, 1, scale, stream)

        if call_dq() or call_dkv():
            raise RuntimeError(f"{name}: launch refused")
        out[name] = {"dq_us": time_us(call_dq), "dkv_us": time_us(call_dkv)}
        print(f"[ablation] B{B} T{T} H{H} hd{hd} {name}: dq "
              f"{out[name]['dq_us']:.1f} us, dk/dv "
              f"{out[name]['dkv_us']:.1f} us", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_backward_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    directory = _build.BUILD_DIR / "ablation"
    directory.mkdir(parents=True, exist_ok=True)
    libs = build(str(directory))
    result = {"card": card.strip(),
              "training": run(libs, 32, 576, 12, 64),
              "gptj": run(libs, 8, 576, 16, 256)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
