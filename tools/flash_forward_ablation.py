"""Where the bf16 flash forward's time goes, on a card.

Builds copies of ``trlx_tpu_torch/csrc/flash_forward.cu`` (into
``build/kernels/ablation/``, git-ignored) with parts of its tile loop
taken out (their results are wrong: only their times count), with the
grid in the head-minor order, or with its consumer count or stages
changed, and times the forward with CUDA events at the training shape
(B 32, T 576, H 12, hd 64), at gpt-j-6B's (B 8, T 576, H 16, hd 256)
and at B 8, T 2048, H 12, hd 64 (where operations bound it), causal,
bf16. Prints one line per variant and shape, then one JSON
object with every time. Run from the repository root on a machine with
the card and nvcc::

    python3 tools/flash_forward_ablation.py

Variants: ``as built``; ``no P V`` (O += P V gone); ``no softmax terms``
(P is the raw scores); ``no S products`` (S left stale); ``data path
only`` (all three gone: the loads, barriers and stores remain);
``head-minor grid`` (a head's blocks spread across the grid, as the
mma.sync forward ordered them); the plans ``one consumer warpgroup``
(64 query rows a block, three blocks an SM to hd 64, two beyond where
shared memory allows), ``two consumer warpgroups`` (128 rows, one block
an SM) and ``two consumers, two blocks an SM`` (128 rows to hd 64, 104
registers a consumer thread); ``two stages`` (of the K and V rings, at
every head dim) and ``four blocks, two stages`` (one consumer, 104
registers a consumer thread, to hd 64). Each variant
edits an anchor line of the source; a missing anchor raises rather than
time the unchanged kernel. ptxas's notes of spills or serialized wgmma
print per variant.
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

SOURCE = _build.CSRC_DIR / "flash_forward.cu"

S_PRODUCT = ("    wgmma_ss_n64(s, step_k<HD>(qd, kk), step_k<HD>(kd, kk), "
             "kk > 0);")
PV_PRODUCT = ("      wgmma_rs<P::NW>(acc[p], pa[kk], "
              "step_mn<HD>(vd, kk, p * P::NW));")
SOFTMAX = "  float mt[2] = {m[0], m[1]};"
RAW_SCORES = "  alpha[0] = alpha[1] = 1.f;\n  return;\n" + SOFTMAX
ORDER = ("  const int bh = blockIdx.x / n_blk;",
         "  const int ib = n_blk - 1 - (blockIdx.x - bh * n_blk);")
MINOR = ("  const int bh = blockIdx.x % (gridDim.x / n_blk);",
         "  const int ib = n_blk - 1 - blockIdx.x / (gridDim.x / n_blk);")
PLAN = ("  static constexpr int CONSUMERS = HD <= 64 ? 1 : 2;",
        "  static constexpr int BLOCKS = HD <= 64 ? 3 : 1;")
STAGES = "  static constexpr int STAGES = HD <= 128 ? 4 : 2;"
#: the plan variants' (consumer warpgroups, blocks an SM) in place of the
#: built plan's
PLANS = {"one consumer warpgroup": ("1", "HD <= 64 ? 3 : 2"),
         "two consumer warpgroups": ("2", "1"),
         "two consumers, two blocks an SM": ("2", "HD <= 64 ? 2 : 1")}

VARIANTS = ("as built", "no P V", "no softmax terms", "no S products",
            "data path only", "head-minor grid", *PLANS, "two stages",
            "four blocks, two stages")


def replace(src, old, new):
    if old not in src:
        raise ValueError(f"anchor not in {SOURCE.name}: {old[:60]!r}")
    return src.replace(old, new)


def variant(name, src):
    if name in ("no S products", "data path only"):
        src = replace(src, S_PRODUCT, "    {}")
    if name in ("no softmax terms", "data path only"):
        src = replace(src, SOFTMAX, RAW_SCORES)
    if name in ("no P V", "data path only"):
        src = replace(src, PV_PRODUCT, "      {}")
    if name == "head-minor grid":
        for old, new in zip(ORDER, MINOR):
            src = replace(src, old, new)
    if name in ("two stages", "four blocks, two stages"):
        src = replace(src, STAGES, STAGES.replace("HD <= 128 ? 4 : 2", "2"))
    if name == "four blocks, two stages":
        src = replace(src, PLAN[1], PLAN[1].replace("HD <= 64 ? 3 : 1",
                                                    "HD <= 64 ? 4 : 1"))
    if name in PLANS:
        for line, value in zip(PLAN, PLANS[name]):
            src = replace(src, line, line.split(" = ")[0] + f" = {value};")
    return src


def build(directory):
    """Every variant's library, all nvcc processes at once (the copies
    include csrc/hopper.cuh from the source directory)."""
    src = SOURCE.read_text()
    procs = []
    for i, name in enumerate(VARIANTS):
        cu = os.path.join(directory, f"fwd{i}.cu")
        so = os.path.join(directory, f"libfwd{i}.so")
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
        notes = sorted({ln.split(":", 1)[-1].strip()
                        for ln in log.splitlines()
                        if "serialized" in ln or ("bytes spill" in ln
                                                  and " 0 bytes" not in ln)})
        for note in notes:
            print(f"[ablation] {name}: ptxas: {note}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def bind(lib):
    fn = lib.flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
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
    q, k, v = (torch.randn((B, T, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = fa.flash_scale(hd)
    out = {}
    for name, lib in libs.items():
        fwd = bind(lib)

        def call():
            return fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       mask.data_ptr(), o.data_ptr(), lse.data_ptr(), B, T,
                       H, hd, 1, scale, stream)

        rc = call()
        if rc:
            raise RuntimeError(f"{name}: launch refused (CUDA error {rc})")
        out[name] = time_us(call)
        print(f"[ablation] B{B} T{T} H{H} hd{hd} {name}: forward "
              f"{out[name]:.1f} us", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_forward_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    directory = _build.BUILD_DIR / "ablation"
    directory.mkdir(parents=True, exist_ok=True)
    libs = build(str(directory))
    result = {"card": card.strip(),
              "training": run(libs, 32, 576, 12, 64),
              "gptj": run(libs, 8, 576, 16, 256),
              "t2048": run(libs, 8, 2048, 12, 64)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
