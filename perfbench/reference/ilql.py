"""ILQL's first updates written out (plain PyTorch, float32): the trunk,
the architecture's LM head, the V head and two Q heads with
their frozen target copies, the composite loss and AdamW.

The loss is the one the configuration's method names, term by term:
the Q heads' squared TD error against r + gamma V(s'), the expectile
(tau) loss of V against the smaller target Q, the CQL cross-entropy of
each Q head and the AWAC cross-entropy of the LM head, each summed over
the non-terminal positions and divided by their count. As in trlx, V in
the expectile term is read one position on (``vs[:, 1:]``).

The batch is rebuilt here from the rows the benchmark made: each row's
mask has its terminal slot zeroed, its return (the row's reward
whitened over the dataset with the population deviation) sits on its
last reward slot, and every row is right-padded to the dataset's longest
with the pad id. Positions are 0..T-1.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import gpt
from perfbench.reference.optim import AdamW, ramp_lr


def whitened_returns(scores: Sequence[float]) -> np.ndarray:
    s = np.asarray(scores, np.float64)
    return ((s - s.mean()) / (s.std() + 1e-30)).astype(np.float32)


def batch_arrays(rows: List[np.ndarray], returns: np.ndarray, idx,
                 width: int, pad_id: int):
    """(ids, mask, rewards) of rows ``idx``: [B, width] and [B, width-1]."""
    B = len(idx)
    ids = np.full((B, width), pad_id, np.int64)
    mask = np.zeros((B, width), np.int64)
    rewards = np.zeros((B, width - 1), np.float32)
    for b, i in enumerate(idx):
        row = rows[i]
        n = len(row)
        ids[b, :n] = row
        mask[b, :n - 1] = 1
        rewards[b, n - 2] = returns[i]
    return ids, mask, rewards


def param_tree(sd: Dict[str, torch.Tensor], heads: Dict[str, dict]):
    """The trainable float32 parameters (a flat dict: checkpoint names
    and ``<head>.<w1|b1|w2|b2>``) and the frozen target heads."""
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in sd.items()}
    for h in ("v_head", "q1_head", "q2_head"):
        for k, v in heads[h].items():
            params[f"{h}.{k}"] = v.detach().float().clone() \
                .requires_grad_(True)
    targets = {h: {k: v.detach().float().clone() for k, v in
                   heads[h].items()} for h in ("q1_head", "q2_head")}
    return params, targets


def block_loss(params, targets, cfg, ids, mask, rewards, n_total: float,
               method: Dict, prec: gpt.Precision):
    """The rows' share of the loss (their sums over the whole batch's
    non-terminal count) and their parts."""
    get = params.__getitem__
    B, T = ids.shape
    positions = torch.arange(T, device=ids.device).expand(B, T)
    h = gpt.trunk(get, cfg, ids, mask, prec, positions=positions,
                  key_mask=mask)
    model = harness.arch(cfg)
    hn = model.final_norm(get, cfg, h)
    labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
    V = cfg["vocab_size"]
    labels = labels.clamp(0, V - 1)

    def head_of(name, tree=None):
        p = tree if tree is not None else {
            k: params[f"{name}.{k}"] for k in ("w1", "b1", "w2", "b2")}
        return gpt.head(p, hn, prec)

    def gather(x):
        return torch.gather(x, -1, labels[..., None])[..., 0]

    nt = mask[:, :-1].float()
    vs = head_of("v_head")[..., 0]
    qs = [head_of(n) for n in ("q1_head", "q2_head")]
    with torch.no_grad():
        tq = torch.minimum(gather(head_of("q1_head", targets["q1_head"])),
                           gather(head_of("q2_head", targets["q2_head"])))
    tq = tq[:, :-1]
    v_next = vs[:, 1:] * nt
    target = (rewards + method["gamma"] * v_next).detach()
    loss_q = sum((((gather(q)[:, :-1] - target) * nt) ** 2).sum()
                 for q in qs) / n_total
    v = vs[:, 1:] * nt
    w = torch.where(tq >= v, method["tau"], 1.0 - method["tau"])
    loss_v = (w * (tq - v) ** 2 * nt).sum() / n_total

    def ce(x):
        return (-(gather(x) - torch.logsumexp(x, -1))[:, :-1] * nt).sum() \
            / n_total

    loss_cql = sum(ce(q) for q in qs)
    del qs
    loss_awac = ce(model.lm_logits(get, cfg, hn, prec))
    loss = loss_q + loss_v + method["cql_scale"] * loss_cql \
        + method["awac_scale"] * loss_awac
    return loss


def updates(sd, heads, cfg: Dict, rows: List[np.ndarray],
            scores: Sequence[float], batches: List[List[int]], width: int,
            pad_id: int, method: Dict, train: Dict, device,
            prec: gpt.Precision, rows_per_block: int = 8):
    """The first ``len(batches)`` updates, each on its own rows. Returns
    {"losses": [...], "grad": {name: norm of the first update's clipped
    gradient}, "change": {name: norm of the change after the last},
    "pairs": name -> [(name in the checkpoint, slice)]}; ``heads``:
    {v_head, q1_head, q2_head} as drawn (the targets start as copies)."""
    params, targets = param_tree(sd, heads)
    names = list(params)
    start = {n: params[n].detach().clone() for n in names}
    opt = AdamW([params[n] for n in names], train["grad_clip"],
                train["weight_decay"])
    returns = whitened_returns(scores)
    out = {"losses": []}
    with gpt.exact_float32():
        for step, idx in enumerate(batches):
            ids, mask, rewards = (torch.as_tensor(a, device=device) for a in
                                  batch_arrays(rows, returns, idx, width,
                                               pad_id))
            n_total = float(mask[:, :-1].sum().clamp(min=1))
            grads = [torch.zeros_like(params[n]) for n in names]
            total = 0.0
            for s in range(0, len(idx), rows_per_block):
                sl = slice(s, s + rows_per_block)
                loss = block_loss(params, targets, cfg, ids[sl], mask[sl],
                                  rewards[sl], n_total, method, prec)
                parts = torch.autograd.grad(loss, [params[n] for n in names],
                                            allow_unused=True)
                for g, p in zip(grads, parts):
                    if p is not None:
                        g.add_(p)
                total += float(loss.detach())
            out["losses"].append(total)
            lr = ramp_lr(step, train["lr_ramp_steps"],
                         train["learning_rate_init"])
            clipped = opt.step(grads, lr)
            if step == 0:
                out["grad_tensors"] = dict(zip(names, clipped))
    out["change"] = {n: params[n].detach() - start[n] for n in names}
    return out
