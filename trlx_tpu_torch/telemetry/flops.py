"""Analytic model FLOPs and the card's peak: MFU's numerator and
denominator (trlx_tpu.telemetry.flops with a table of NVIDIA cards).

Model FLOPs utilization is achieved matmul FLOPs over the card's peak.
The per-token formulas are the reference's, integer for integer: they
count matmul FLOPs only and leave out the attention's quadratic terms,
so they slightly understate the work and MFU is conservative.
"""

from typing import Optional

#: dense bf16 tensor-core peak per card (NVIDIA data sheets, without
#: sparsity), keyed by ``torch.cuda.get_device_name()``
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H200": 989e12,
    "NVIDIA A100-SXM4-80GB": 312e12,
    "NVIDIA A100-SXM4-40GB": 312e12,
    "NVIDIA A100 80GB PCIe": 312e12,
}


def peak_flops(device=None) -> Optional[float]:
    """The bf16 peak of the card a run uses, or None when there is no
    card, ``device`` is not a CUDA device, or the card is not in
    :data:`PEAK_FLOPS`: callers then omit MFU rather than report a
    wrong one."""
    if device is not None and getattr(device, "type", str(device)) != "cuda":
        return None
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(device)
    except Exception:
        return None
    return PEAK_FLOPS.get(name)


def ppo_train_flops_per_token(spec, num_layers_unfrozen: int) -> int:
    """Matmul FLOPs per (batch x seq) token of one PPO optimization step:
    the forward runs the full depth, the backward only the trainable
    top (the hydra split stops gradients at the frozen trunk)."""
    d, f, L, V = spec.d_model, spec.d_ff, spec.n_layer, spec.vocab_size
    per_layer = 2 * (4 * d * d + 2 * d * f)  # qkv + o, mlp in / out
    fwd = L * per_layer + 2 * d * V  # + the logits projection
    k = num_layers_unfrozen if num_layers_unfrozen >= 0 else L
    bwd = 2 * (k * per_layer + 2 * d * V)
    return fwd + bwd


def decode_flops_per_token(spec) -> int:
    d, f, L, V = spec.d_model, spec.d_ff, spec.n_layer, spec.vocab_size
    return L * 2 * (4 * d * d + 2 * d * f) + 2 * d * V


def kv_bytes_per_token(spec, kv_dtype: str = "bf16") -> int:
    """Resident KV-pool bytes one committed token costs: ``bf16`` k + v,
    ``head_dim`` 2-byte elements per kv-head per layer; ``int8``
    ``head_dim`` 1-byte codes plus one f32 scale per (token, kv-head)."""
    per_head = (
        spec.head_dim + 4 if kv_dtype == "int8" else 2 * spec.head_dim
    )
    return 2 * spec.n_layer * spec.kv_heads * per_head


def ilql_train_flops_per_token(
    spec, num_layers_unfrozen: int, two_qs: bool = True
) -> int:
    """Matmul FLOPs per token of one ILQL step: the trunk forward and the
    vocabulary-wide LM / Q / target-Q / V heads, the backward through
    the trainable top and the LM / Q / V heads (the target-Q copies are
    frozen)."""
    d, f, L, V = spec.d_model, spec.d_ff, spec.n_layer, spec.vocab_size
    n_q = 2 if two_qs else 1
    per_layer = 2 * (4 * d * d + 2 * d * f)
    heads_fwd = (1 + 2 * n_q) * 2 * d * V + 2 * d  # lm + q + target_q, v
    k = num_layers_unfrozen if num_layers_unfrozen >= 0 else L
    fwd = L * per_layer + heads_fwd
    bwd = 2 * (k * per_layer + (1 + n_q) * 2 * d * V + 2 * d)
    return fwd + bwd


def mfu_estimate(tokens_per_sec: float, flops_per_token: float,
                 device=None) -> Optional[float]:
    """Achieved over peak FLOPs, or None when either side is unknown."""
    peak = peak_flops(device)
    if not peak or not flops_per_token or not tokens_per_sec:
        return None
    return tokens_per_sec * flops_per_token / peak
