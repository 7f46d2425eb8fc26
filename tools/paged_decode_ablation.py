"""Where paged decode's time goes, on a card.

Builds copies of ``trlx_tpu_torch/csrc/paged_decode.cu`` (into
``build/kernels/ablation/``, git-ignored) with one part of its design
changed or taken out, and times each with CUDA events, bf16 q, full-length
rows, pages of 16: the serving shape (16 slots, H = Hkv 12, hd 64, 4
pages), the same over the int8 pool, a tp shard of it (H = Hkv 3),
gpt-j-6B's serving shape (H 16, hd 256), a 1024-token context (16
slots, hd 64) and one slot's 4096-token stream (H 12, hd 64). Each shape is timed two ways, each as a CUDA graph
of many launches cycling enough pool copies to pass the 50 MB L2: the
kernel alone, back to back, and after a scatter into its pool (one page
of each slot, as the serve step writes the fresh token's K/V just
before), less the scatter alone; every variant's graphs replay in turns,
six rounds, and each time is the median. Prints ptxas's registers and spills per variant,
one line per variant and shape, then one JSON object with every time.
Run from the repository root on a machine with the card and nvcc::

    python3 tools/paged_decode_ablation.py

Variants: ``as built``; ``with PDL`` (launched with programmatic stream
serialization, so the producer's prologue and the consumers' start run
while the kernel before it drains, each waiting on griddepcontrol.wait
before it reads q or the pool); ``a ring of one stage`` (each page
issued after the one before it was consumed) and rings of at most 2, 4
and 8 stages (the kernel's own depth is every page of a serving context,
else as many as the SM's shared memory holds, at most 16), which use the
compact ring wherever they hold fewer stages than the partition has
pages; ``no direct ring`` (the compact ring's prologue, the bias scan and
the page list, before the first copy at every shape); ``merge through
device memory`` (with P > 1 each block writes its
float32 (m, l, acc) to global scratch and a second kernel merges them,
the design before the cluster merge); ``data path only`` (the consumers
wait for each page and hand it back without touching it: the prologue,
the copies, the barriers and the merge remain; its outputs are wrong,
only its times count). Each variant edits an anchor of the source; a
missing anchor raises rather than time the unchanged kernel.
"""

import ctypes
import json
import math
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from trlx_tpu_torch.models.transformer import _rsqrt_scale, quantize_kv  # noqa: E402,E501
from trlx_tpu_torch.ops import _build  # noqa: E402
from trlx_tpu_torch.ops import paged_attention as pa  # noqa: E402

SOURCE = _build.CSRC_DIR / "paged_decode.cu"

ATTR = "  cudaLaunchAttribute attrs[1];"
PDL_ATTR = """  cudaLaunchAttribute attrs[2];
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;"""
COUNT = "  cfg.numAttrs = 1;"
WAIT = '    asm volatile("griddepcontrol.wait;" ::: "memory");\n'
DIRECT_ISSUE = ("      // each page into its own stage: lane k the boxes of "
                "page k, then\n")
COMPACT_ISSUE = "      // the used pages in order, each into the next ring stage\n"
CONSUMER = ("    if (P > 1 && !direct) cluster_arrive();  // the liveness "
            "phase\n")
STAGES = "  const int stages = ring_stages<KV, HD>("
STAGES_OK = "  if (stages == 0) return cudaErrorInvalidValue;"
DIRECT = "  const bool direct = pages_per <= stages;"
MERGE = ("  if (P > 1)\n    merge_partitions<QT, HD, GT>(part_s, out + q_row, "
         "P, part,\n                                 !direct && !waited);")
STORE = "  if (P > 1) store_partials<HD, GT>(part_s, s, H, h0, P, part);"
KERNEL = "// one block per (slot, kv-head x head group, partition); module comment"
RETURN = "  return launched;"
CONSUME = "          consume_rows<QT, KV, HD, GT>("
#: the merge through device memory: global float32 scratch and a second
#: kernel that reads a (slot, head)'s P rows in partition order
DEVICE_MERGE = """__device__ float g_partials[1 << 21];

template <int HD, int GT>
__device__ __forceinline__ void store_partials(const float* part_s, int s,
                                               int H, int h0, int P,
                                               int part) {
  constexpr int RED = HD + 2;
  __syncthreads();
  for (int i = threadIdx.x; i < GT * RED; i += kThreads) {
    const int g = i / RED;
    g_partials[((static_cast<size_t>(s) * H + h0 + g) * P + part) * RED +
               i - g * RED] = part_s[i];
  }
}

template <typename QT, int HD>
__global__ void paged_decode_combine_kernel(QT* __restrict__ out, int P) {
  constexpr int RED = HD + 2;
  const float* pp = g_partials + static_cast<size_t>(blockIdx.x) * P * RED;
  float M = kMaxInit;
  for (int p = 0; p < P; ++p) M = fmaxf(M, pp[p * RED]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int p = 0; p < P; ++p) {
      const float f = exp2f((pp[p * RED] - M) * kLog2e);
      L = fmaf(pp[p * RED + 1], f, L);
      A = fmaf(pp[p * RED + 2 + d], f, A);
    }
    out[static_cast<size_t>(blockIdx.x) * HD + d] =
        from_f32<QT>(A / fmaxf(L, 1e-30f));
  }
}

"""
COMBINE = """  if (launched != cudaSuccess || a.partitions == 1) return launched;
  paged_decode_combine_kernel<QT, HD><<<a.S * a.H, HD, 0, a.stream>>>(
      static_cast<QT*>(a.out), a.partitions);
  return cudaGetLastError();"""

#: the ring-depth variants: name -> most stages
CAPS = {"a ring of one stage": 1, "a ring of at most 2 stages": 2,
        "a ring of at most 4 stages": 4, "a ring of at most 8 stages": 8}

VARIANTS = ("as built", "with PDL", *CAPS, "no direct ring",
            "merge through device memory", "data path only")

#: key -> (slots, H = Hkv, hd, max_pages, int8 pool)
SHAPES = {
    "serving hd 64": (16, 12, 64, 4, False),
    "serving hd 64, int8 pool": (16, 12, 64, 4, True),
    "tp shard H 3 hd 64": (16, 3, 64, 4, False),
    "gpt-j serving hd 256": (16, 16, 256, 4, False),
    "1024 tokens hd 64": (16, 12, 64, 64, False),
    "1 x 4096 tokens hd 64": (1, 12, 64, 256, False),
}


def replace(src, old, new):
    if old not in src:
        raise ValueError(f"anchor not in {SOURCE.name}: {old[:60]!r}")
    return src.replace(old, new)


def variant(name, src):
    if name == "with PDL":
        src = replace(src, ATTR, PDL_ATTR)
        src = replace(src, COUNT, COUNT.replace("1;", "2;"))
        src = replace(src, DIRECT_ISSUE, WAIT + DIRECT_ISSUE)
        src = replace(src, COMPACT_ISSUE, WAIT + COMPACT_ISSUE)
        src = replace(src, CONSUMER, CONSUMER + WAIT)
    if name in CAPS:
        src = replace(src, STAGES, STAGES.replace("const int", "int"))
        src = replace(src, STAGES_OK, STAGES_OK + "\n  stages = std::min("
                      f"stages, {CAPS[name]});")
    if name == "no direct ring":
        src = replace(src, DIRECT, "  const bool direct = false;")
    if name == "merge through device memory":
        src = replace(src, MERGE, STORE)
        src = replace(src, KERNEL, DEVICE_MERGE + KERNEL)
        src = replace(src, RETURN, COMBINE)
    if name == "data path only":
        src = replace(src, CONSUME, CONSUME.replace("consume_rows",
                                                    "if (false) consume_rows"))
    return src


def build(directory):
    """Every variant's library, all nvcc processes at once (the copies
    include csrc/hopper.cuh from the source directory)."""
    src = SOURCE.read_text()
    procs = []
    for i, name in enumerate(VARIANTS):
        cu = os.path.join(directory, f"paged{i}.cu")
        so = os.path.join(directory, f"libpaged{i}.so")
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
        print(f"[ablation] {name}: ptxas: {ptxas_notes(log)}", flush=True)
        libs[name] = pa._bind(ctypes.CDLL(so))
    return libs


def ptxas_notes(log):
    """Registers of the serve paths' instances (bf16 q over a bf16 or
    int8 pool, hd 64 and 256, one head a block) and every spill."""
    out, name = [], "?"
    for ln in log.splitlines():
        m = re.search(r"paged_decode_kernelI(\w+?)EEv", ln)
        if "Compiling entry function" in ln and m:
            name = "<" + ", ".join(re.findall(r"Li(\d+)", m.group(1))) + ">"
            name = ("f32" if m.group(1).startswith("f") else "bf16") + name
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and m.group(1) != "0":
            out.append(f"{name} spills {m.group(1)} B")
        m = re.search(r"Used (\d+) registers", ln)
        if m and name in ("bf16<1, 64, 1>", "bf16<2, 64, 1>",
                          "bf16<1, 256, 1>", "bf16<2, 256, 1>"):
            out.append(f"{name} {m.group(1)} registers")
    return "; ".join(out)


def case(S, H, hd, max_pages, int8, seed=0):
    """bf16 q and full-length rows over shuffled pages of 16, with enough
    pool copies to pass the L2; page table and bias made first, as the
    serve step makes them before its scatter."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    num_pages = S * max_pages
    pt = torch.randperm(num_pages, generator=gen, device="cuda").to(
        torch.int32).reshape(S, max_pages)
    bias = torch.zeros((S, max_pages * 16), device="cuda")
    row = hd + 4 if int8 else 2 * hd
    copies = max(1, math.ceil(120e6 / (2 * num_pages * 16 * H * row)))
    q = torch.randn((S, H, hd), generator=gen, device="cuda").bfloat16()
    pools = []
    for _ in range(copies):
        k, v = (torch.randn((num_pages, 16, H, hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        pools.append((quantize_kv(k), quantize_kv(v)) if int8 else (k, v))
    return q, pools, pt, bias


def capture(fn, n, iters):
    """A CUDA graph of ``iters`` calls fn(i), i cycling 0 .. n - 1, after
    a warm-up off the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(n, 3)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n)
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_us(graphs, iters, rounds=6):
    """Device µs per call of each graph: the median over ``rounds``
    replays, the graphs taken in turns (forward, then reversed)."""
    samples = [[] for _ in graphs]
    order = list(range(len(graphs)))
    for r in range(rounds):
        for i in (order if r % 2 == 0 else order[::-1]):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            graphs[i].replay()
            stop.record()
            torch.cuda.synchronize()
            samples[i].append(start.elapsed_time(stop) * 1e3 / iters)
    return [sorted(s)[len(s) // 2] for s in samples]


def run(libs, S, H, hd, max_pages, int8, iters=200):
    q, pools, pt, bias = case(S, H, hd, max_pages, int8)
    P, per = pa.decode_partitions(S, H, max_pages, 16)
    out = torch.empty_like(q)
    rows = torch.arange(S, device="cuda") * max_pages  # one page a slot
    fresh = torch.randn((S, 16, H, hd), device="cuda").bfloat16()
    fresh = quantize_kv(fresh)[0] if int8 else fresh
    scale = _rsqrt_scale(hd)

    def scatter(i):
        k = pools[i][1]
        (k[0] if int8 else k).index_copy_(0, rows, fresh)

    def decoder(name, fn):
        def decode(i):
            k, v = pools[i]
            kc, ks = k if int8 else (k, None)
            vc, vs = v if int8 else (v, None)
            rc = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                    ks.data_ptr() if int8 else None,
                    vs.data_ptr() if int8 else None, pt.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), S, H, H, hd,
                    S * max_pages, 16, max_pages, P, 1,
                    2 if int8 else 1, scale,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch refused (CUDA error {rc})")
        return decode

    graphs = [capture(scatter, len(pools), iters)]
    for name, fn in libs.items():
        decode = decoder(name, fn)

        def pair(i, decode=decode):
            scatter(i)
            decode(i)
        graphs += [capture(decode, len(pools), iters),
                   capture(pair, len(pools), iters)]
    us = replay_us(graphs, iters)
    times = {name: {"alone_us": us[1 + 2 * k],
                    "after_scatter_us": us[2 + 2 * k] - us[0]}
             for k, name in enumerate(libs)}
    del graphs
    return {"P": P, "pages_per": per, "scatter_us": us[0], "times": times}


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    directory = _build.BUILD_DIR / "ablation"
    directory.mkdir(parents=True, exist_ok=True)
    libs = build(str(directory))
    result = {"card": card.strip()}
    for key, shape in SHAPES.items():
        r = result[key] = run(libs, *shape)
        for name, t in r["times"].items():
            print(f"[ablation] {key} (P={r['P']} x {r['pages_per']} pages) "
                  f"{name}: alone "
                  f"{t['alone_us']:.2f} us, after a scatter "
                  f"{t['after_scatter_us']:.2f} us", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
