"""Seeded checkpoints in Hugging Face's layout, made on the device.
The layout (each matrix's name and shape of any rank, each bias and norm
vector) is the architecture's: ``matrices`` and ``vectors`` of its
module, ``arch/<arch>.py``.

Both sides of a run read these: the program through its own converter,
and the plain reference (``perfbench/reference``) directly. Every matrix
is a view of one flat buffer that a single ``normal_`` call fills from a
generator on the device, so a 6B checkpoint takes a few large calls and
the same seed gives the same bytes again after the program is gone.

N(0, 0.02) matrices, the residual projections (attention out and MLP
out) scaled by 1 / sqrt(2 n_layer), zero biases, unit norm scales.
"""

import math
from typing import Dict

import torch

from perfbench import harness


@torch.no_grad()
def state_dict(cfg: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The seeded checkpoint of model config ``cfg`` (perfbench/configs'
    ``spec`` block) on ``device`` in ``dtype``."""
    model = harness.arch(cfg)
    mats = model.matrices(cfg)
    total = sum(math.prod(shape) for _, shape, _ in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 0.02, generator=gen)
    resid = 1.0 / math.sqrt(2 * cfg["n_layer"])
    sd, at = {}, 0
    for name, shape, residual in mats:
        n = math.prod(shape)
        view = flat[at:at + n].view(shape)
        if residual:
            view.mul_(resid)
        sd[name] = view
        at += n
    vecs = model.vectors(cfg)
    ones = torch.ones(sum(n for _, n, v in vecs if v == 1.0), dtype=dtype,
                      device=device)
    zeros = torch.zeros(sum(n for _, n, v in vecs if v == 0.0), dtype=dtype,
                        device=device)
    at_one = at_zero = 0
    for name, n, value in vecs:
        if value == 1.0:
            sd[name] = ones[at_one:at_one + n]
            at_one += n
        else:
            sd[name] = zeros[at_zero:at_zero + n]
            at_zero += n
    return sd
