"""The bf16 flash forward's host side on the CPU: csrc/flash_forward.cu
(wgmma, TMA) runs only on a card, so what these tests hold is what
surrounds it — the block's plan at every head dim (boxes, the swizzle's
period, shared memory, the consumer warpgroups and their setmaxnreg
split), the tensor maps it encodes at the main path's shapes, the C
entry points the wrappers bind, and a torch model of its softmax in log2
units (scale * log2 e folded into the scores, exp2, lse = m ln 2 +
log l) held to the bound the card checks it to against the plain
version. The kernel itself runs in tests/test_torch_cuda_kernels.py and
chip_smoke.py; the plain forward against trlx_tpu's interpret-mode
Pallas forward in tests/test_torch_flash_attention.py."""

import re

import numpy as np
import pytest
import torch

from trlx_tpu_torch.ops import _build
from trlx_tpu_torch.ops import flash_attention as fa

#: the main path's shapes (training, ILQL, gpt-j's TL;DR, B 8 at T 2048)
#: and a ragged one (T not a multiple of 4 or of the 64-row tile)
MAP_SHAPES = [(32, 576, 12), (80, 500, 12), (8, 576, 16), (8, 2048, 12),
              (3, 130, 2)]


#: the forward's plan at each head dim, written out: consumer warpgroups,
#: blocks an SM, threads a block, registers a thread (at launch, the
#: producer's and a consumer's after setmaxnreg), stages, shared memory
PLANS = {16: (1, 3, 256, (80, 24, 136), 4, 20616),
         32: (1, 3, 256, (80, 24, 136), 4, 39048),
         64: (1, 3, 256, (80, 24, 136), 4, 75912),
         128: (2, 1, 384, (168, 24, 240), 4, 166024),
         256: (2, 1, 384, (168, 24, 240), 2, 198216)}


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_forward_tile_plan_fits_one_block(hd):
    """The bf16 forward's plan is the one written out in ``PLANS`` (one
    consumer warpgroup of 64 query rows a block and three blocks an SM
    to hd 64, two consumers a block from hd 128, each with a producer
    warpgroup that hands its registers over), and it fits the card: the
    boxes cover the head dim, the tiles keep the 128 B swizzle's 1024 B
    period, every consumer keeps all output columns (S formed once per
    row block, hd 256 too) and holds O, S and P with room to spare, the
    blocks of an SM fit its register file and its shared memory, each
    at most one Hopper block's 232,448 bytes."""
    g = fa.forward_geometry(hd)
    consumers, blocks, threads, (launch, producer, consumer), stages, \
        smem = PLANS[hd]
    regs = g["registers"]
    assert (g["consumers"], g["blocks"], g["threads"], g["stages"]) == \
        (consumers, blocks, threads, stages)
    assert (regs["launch"], regs["producer"], regs["consumer"]) == \
        (launch, producer, consumer)
    assert fa.shared_memory_bytes(hd)["flash_fwd"] == smem
    assert g["box_cols"] * g["boxes"] == hd
    assert g["row_bytes"] == 2 * g["box_cols"] in (32, 64, 128)
    assert g["tile_bytes"] == fa.TILE * 2 * hd
    assert g["tile_bytes"] % 1024 == 0
    assert g["rows"] == g["consumers"] * fa.TILE and g["out_cols"] == hd
    # the register file holds every block's threads at launch, and the
    # producer warpgroup frees what the consumers take
    assert blocks * threads * launch <= 65536
    assert producer + consumers * consumer == (consumers + 1) * launch
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in regs.values())
    # O's 64 x hd float32 accumulators over 128 threads, S, P's fragments
    assert hd // 2 + 32 + 16 <= consumer - 32
    assert stages >= 2  # K runs a tile ahead of V
    assert smem <= 232448
    assert blocks * (smem + 1024) <= 233472  # 1 KB reserved a block


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("B,T,H", MAP_SHAPES)
def test_forward_tma_maps_obey_the_hardware_rules(B, T, H, hd):
    """The tensor maps the bf16 forward encodes for q, k and v obey
    cuTensorMapEncodeTiled's rules (rank 1-5, dims below 2^32, global
    strides multiples of 16 bytes below 2^40, every box dim 1-256, the
    inner box a multiple of 16 bytes and, under a swizzle, exactly its
    width of at most 128 bytes) and match the kernel's plan: a box is one
    of a tile's column boxes, 64 rows, and a block's query rows are whole
    boxes, one per consumer."""
    m = fa.tma_maps(B, T, H, hd)["q/k/v/dO/O"]
    g = fa.forward_geometry(hd)
    dims, box, strides = m["dims"], m["box"], m["strides"]
    assert 1 <= len(dims) <= 5 and len(box) == len(dims)
    assert len(strides) == len(dims) - 1
    assert all(0 < d < 2 ** 32 for d in dims)
    assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in strides)
    assert all(1 <= b <= 256 for b in box)
    inner = box[0] * m["elem"]
    assert inner % 16 == 0 and inner == m["swizzle"] <= 128
    assert m["swizzle"] == g["row_bytes"] and box[0] == g["box_cols"]
    assert box[2] * inner * g["boxes"] == g["tile_bytes"]
    assert dims == (hd, H, T, B) and strides[-1] == 2 * hd * H * T
    assert g["rows"] == g["consumers"] * box[2]


def _signature(source, name):
    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert found, (source, name)
    return [" ".join(p.split()) for p in found.group(1).split(",")]


@pytest.mark.parametrize("kind", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_bind_the_c_entry_points(kind, dtype):
    """Each wrapper binds the entry point of its dtype in a built source
    (bfloat16 on wgmma: flash_forward.cu / flash_backward.cu; float32 on
    the CUDA cores: flash_attention.cu), and the ctypes argument types
    match the C signature: ``_POINTERS`` pointers, five ints (B, T, H,
    hd, causal), the float scale, the stream."""
    source, name = fa._entry(kind, dtype)
    assert source in _build.KERNELS
    if dtype == torch.bfloat16:
        assert source == ("flash_forward" if kind == "fwd"
                          else "flash_backward")
    else:
        assert source == "flash_attention"
    params = _signature(source, name)
    n = fa._POINTERS[name]
    assert all("*" in p for p in params[:n]), params
    assert params[n:] == ["int B", "int T", "int H", "int hd", "int causal",
                          "float scale", "void* stream"], params


def _case(seed, B, T, H, hd, pads=()):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, hd))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    mask = np.ones((B, T), np.int32)
    for i, p in enumerate(pads):
        mask[i, :p] = 0
    return q, k, v, torch.from_numpy(mask)


def _log2_forward_model(q, k, v, mask, causal):
    """The bf16 forward kernel's arithmetic in float32 torch: per 64-row
    query tile (a consumer warpgroup's), 64-key tiles in order (those
    wholly above the diagonal skipped); scores in log2 units, S * (scale
    * log2 e) + bias * log2 e; the running max from -1e30; alpha = 2^(m -
    m_new); P = 2^(S - m_new), rounded to bf16 before P V while the row
    sum takes P unrounded; O = acc / max(l, 1e-30) rounded once to bf16;
    lse = m ln 2 + log(l)."""
    B, T, H, hd = q.shape
    log2e = 1.4426950408889634
    sl = fa.flash_scale(hd) * log2e
    qf, kf, vf = (x.float() for x in (q, k, v))
    key_bias = torch.where(mask > 0, 0.0, fa.NEG_INF * log2e).float()
    out = torch.empty(B, T, H, hd)
    lse = torch.empty(B, H, T)
    n = -(-T // fa.TILE)
    for iq in range(n):
        rows = slice(iq * fa.TILE, min(T, (iq + 1) * fa.TILE))
        m = torch.full((B, H, rows.stop - rows.start), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, rows.stop - rows.start, hd)
        for jt in range(iq + 1 if causal else n):
            keys = slice(jt * fa.TILE, min(T, (jt + 1) * fa.TILE))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, keys]) \
                * sl + key_bias[:, None, None, keys]
            if causal and jt == iq:
                qpos = torch.arange(rows.start, rows.stop)[:, None]
                kpos = torch.arange(keys.start, keys.stop)[None, :]
                s = s + torch.where(qpos < kpos, fa.NEG_INF * log2e, 0.0)
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf[:, keys])
            m = m_new
        l = l.clamp(min=1e-30)
        out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3)
        lse[..., rows] = m * np.log(2.0) + torch.log(l)
    return out.to(torch.bfloat16), lse


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("T,causal,pads", [
    (130, True, (0, 130, 17)),  # ragged T, one fully left-padded row
    (96, False, (0, 9)),
])
def test_log2_softmax_model_within_tolerance(hd, T, causal, pads):
    """The bf16 forward kernel's softmax in log2 units, modelled in torch,
    stays inside the bound the card checks it to against the plain
    version on the same bf16 inputs: O on real rows at largest |err| /
    (1e-2 + 1e-2 |ref|) below 0.6 (the card passes at 1), lse on real
    rows at atol 1e-3, every row finite (the fully left-padded one
    too)."""
    q, k, v, mask = _case(500 + hd + T, len(pads), T, 2, hd, pads)
    out, lse = _log2_forward_model(q, k, v, mask, causal)
    ref, lse_ref = fa.flash_fwd_reference(q, k, v, mask, causal)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    real = mask.bool()
    err = (out.float() - ref.float())[real].abs()
    assert (err / (1e-2 + 1e-2 * ref.float()[real].abs())).max() < 0.6
    torch.testing.assert_close(lse.permute(0, 2, 1)[real],
                               lse_ref.permute(0, 2, 1)[real], atol=1e-3,
                               rtol=0)
