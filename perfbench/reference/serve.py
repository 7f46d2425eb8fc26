"""Greedy serving written out: one full forward of the model over each
prompt and the tokens served after it (float32), and how far below the
reference's best logit each served token's logit lies. A served token
that the reference also ranks first lies 0 below it."""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import gpt
from perfbench.reference.ppo import layer_weights


@torch.no_grad()
def logits(sd, cfg: Dict, rows: Sequence[Tuple[List[int], List[int]]],
           prec: gpt.Precision, device) -> List[torch.Tensor]:
    """Per (prompt, served) row: float32 logits [n_served, V] at the
    positions that predict each served token."""
    model = harness.arch(cfg)
    hs, biases, positions, masks = [], [], [], []
    with gpt.exact_float32():
        for prompt, served in rows:
            tokens = torch.as_tensor([list(prompt) + list(served[:-1])],
                                     device=device)
            mask = torch.ones_like(tokens)
            pos = gpt.positions_of(mask)
            masks.append(mask)
            positions.append(pos)
            biases.append(gpt.causal_bias(mask))
            hs.append(model.embed(sd.__getitem__, cfg, tokens, pos))
        for i in range(cfg["n_layer"]):
            w = layer_weights(sd, cfg, i)
            for j in range(len(hs)):
                hs[j] = model.block(w.__getitem__, cfg, i, hs[j], biases[j],
                                    positions[j], prec, masks[j])
            del w
        out = []
        for (prompt, served), h in zip(rows, hs):
            hn = model.final_norm(sd.__getitem__, cfg, h[0, len(prompt) - 1:])
            out.append(model.lm_logits(sd.__getitem__, cfg, hn, prec))
    return out


def gaps_of(ref_logits: torch.Tensor, tokens) -> np.ndarray:
    """How far each token's reference logit lies below the reference's
    best at its position."""
    tokens = torch.as_tensor(np.asarray(tokens), device=ref_logits.device)
    best = ref_logits.max(-1).values
    mine = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return (best - mine).cpu().numpy()
