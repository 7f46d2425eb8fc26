"""Norms of the reference's tensors, grouped as the program groups its
parameters into leaves (per block matrix, stacked over the layers it
trains; q, k and v apart), so that the two sides compare leaf by leaf.
The names are the program's tree paths, as plain strings; each
architecture's module maps its checkpoint names to them (``LEAVES``:
name pattern, [(leaf, the part of the tensor the leaf holds, or None for
all of it)])."""

import re
from typing import Dict

import torch

from perfbench import harness


def leaf_norms(tensors: Dict[str, torch.Tensor],
               cfg: Dict) -> Dict[str, float]:
    """{program leaf: L2 norm} of reference tensors named as in the
    checkpoint of configuration ``cfg`` (its ``spec``), heads as
    ``<head>.<w1|b1|w2|b2>``."""
    table = harness.arch(cfg).LEAVES
    squares: Dict[str, float] = {}
    for name, t in tensors.items():
        t = t.detach().double()
        if re.fullmatch(r"(v|q1|q2)_head\.(w1|b1|w2|b2)", name):
            parts = [(name, None)]
        else:
            parts = next((p for pat, p in table if re.fullmatch(pat, name)),
                         None)
            if parts is None:
                raise KeyError(f"no program leaf for {name}")
        for leaf, part in parts:
            x = t if part is None else part(t)
            squares[leaf] = squares.get(leaf, 0.0) + float((x ** 2).sum())
    return {k: v ** 0.5 for k, v in squares.items()}
