"""PPO's rollout scoring and first updates written out (plain PyTorch,
float32), from the checkpoint, the prompts and the sampled tokens.

Rollout: one forward of the policy over prompt + response gives the
response tokens' logprobs and the value head's values at the positions
before them; at the first cycle the reference branch is a copy of the
policy's top, so the per-token KL penalty is 0. The reward model is the
same trunk with its own scalar head, read at each sequence's last real
token (the response stops being real after its first eos); its score is
the reward of that token.

Update: GAE (gamma, lambda) over the response with the episode ending at
the last real token, advantages whitened over the real tokens (unbiased
variance), the clipped policy loss and the clipped value loss (the mean
over real tokens), AdamW after clipping by the global norm, on the
trainable top blocks, the final norm, the LM head and the value head,
with the frozen trunk's output held as it was computed once.
"""

from typing import Dict, List

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import gpt
from perfbench.reference.optim import AdamW


def gen_mask_of(response: torch.Tensor, eos: int) -> torch.Tensor:
    """1 up to and including each row's first eos, 0 after it."""
    is_eos = (response == eos).long()
    before = torch.cumsum(is_eos, dim=1) - is_eos
    return (before == 0).long()


def layer_weights(sd, cfg, i: int) -> Dict[str, torch.Tensor]:
    prefix = harness.arch(cfg).layer_prefix(cfg, i)
    return {k: v.float() for k, v in sd.items() if k.startswith(prefix)}


@torch.no_grad()
def rollout(sd, cfg: Dict, query, qmask, response, v_head, r_head,
            eos: int, k_top: int, prec: gpt.Precision,
            rows_per_block: int = 8) -> Dict[str, torch.Tensor]:
    """Reference logprobs, values, rewards and gen_mask [N, G] of the
    sampled ``response`` after ``query``, and the frozen trunk's output
    [N, T, d] (``h_split``) for the update."""
    N, P = query.shape
    G = response.shape[1]
    L = cfg["n_layer"]
    model = harness.arch(cfg)
    tokens = torch.cat([query, response], dim=1)
    mask = torch.cat([qmask, torch.ones_like(response)], dim=1)
    positions = gpt.positions_of(mask)
    gen_mask = gen_mask_of(response, eos)
    out = {"gen_mask": gen_mask}
    with gpt.exact_float32():
        h = model.embed(sd.__getitem__, cfg, tokens, positions)
        blocks = [slice(s, s + rows_per_block)
                  for s in range(0, N, rows_per_block)]
        biases = [gpt.causal_bias(mask[b]) for b in blocks]
        for i in range(L):
            if i == L - k_top:
                out["h_split"] = h.clone()
            w = layer_weights(sd, cfg, i)
            for b, bias in zip(blocks, biases):
                h[b] = model.block(w.__getitem__, cfg, i, h[b], bias,
                                   positions[b], prec, mask[b])
            del w
        hn = model.final_norm(sd.__getitem__, cfg, h)
        del h
        logprobs = []
        for b in blocks:
            logits = model.lm_logits(sd.__getitem__, cfg, hn[b, P - 1:-1],
                                     prec)
            logprobs.append(torch.gather(torch.log_softmax(logits, -1), -1,
                                         response[b, :, None].long())[..., 0])
        out["logprobs"] = torch.cat(logprobs)
        out["values"] = gpt.head(v_head, hn[:, P - 1:-1], prec)[..., 0]
        last = P + gen_mask.sum(1) - 1
        rows = torch.arange(N, device=hn.device)
        out["scores"] = gpt.head(r_head, hn[rows, last], prec)[:, 0]
    rewards = torch.zeros(N, G, device=hn.device)
    rewards[rows, gen_mask.sum(1) - 1] += out["scores"]
    out["rewards"] = rewards
    return out


def gae(values, rewards, mask, gamma: float, lam: float):
    """(advantages, returns) with V = 0 past each row's last real token."""
    m = mask.float()
    G = values.shape[1]
    v_next = torch.cat([values[:, 1:] * m[:, 1:],
                        torch.zeros_like(values[:, :1])], dim=1)
    deltas = (rewards + gamma * v_next - values) * m
    adv = torch.zeros_like(values)
    run = torch.zeros_like(values[:, 0])
    for t in range(G - 1, -1, -1):
        run = deltas[:, t] + gamma * lam * run
        adv[:, t] = run
    return adv, adv + values


def whiten(x, mask):
    m = mask.float()
    n = m.sum()
    mean = (x * m).sum() / n
    var = (((x - mean) ** 2) * m).sum() / (n - 1)
    return (x - mean) / torch.sqrt(var + 1e-8)


def masked_mean(x, mask):
    m = mask.float()
    return (x * m).sum() / m.sum().clamp(min=1)


def top_prefixes(cfg: Dict, k_top: int):
    """Name prefixes of the top ``k_top`` blocks and of the parameters
    after them."""
    model, L = harness.arch(cfg), cfg["n_layer"]
    return tuple(model.layer_prefix(cfg, i) for i in range(L - k_top, L)) \
        + tuple(model.final_prefixes(cfg))


def top_params(sd, cfg: Dict, v_head, k_top: int) -> Dict[str, torch.Tensor]:
    """The trainable float32 leaves: the top blocks, the parameters after
    them (the final norm, an untied LM head) and the value head
    (``v_head.<w1|b1|w2|b2>``)."""
    out = {k: v.detach().float().clone().requires_grad_(True)
           for k, v in sd.items() if k.startswith(top_prefixes(cfg, k_top))}
    for k, v in v_head.items():
        out[f"v_head.{k}"] = v.detach().float().clone().requires_grad_(True)
    return out


def updates(sd, cfg: Dict, v_head, batch: Dict[str, torch.Tensor],
            method: Dict, train: Dict, k_top: int, steps: int,
            prec: gpt.Precision, rows_per_block: int = 8) -> Dict:
    """``steps`` updates on one minibatch (the rows of ``batch``: query,
    qmask, response, h_split and the reference's own logprobs, values,
    rewards and gen_mask). Both losses are means over the batch's real
    tokens, so each block of rows adds its share of the gradient. Returns
    losses, the first update's clipped gradients and the change of every
    leaf after the last."""
    params = top_params(sd, cfg, v_head, k_top)
    names = list(params)
    start = {n: params[n].detach().clone() for n in names}
    opt = AdamW([params[n] for n in names], train["grad_clip"],
                train["weight_decay"])
    L = cfg["n_layer"]
    model = harness.arch(cfg)
    query, response = batch["query"], batch["response"]
    P = query.shape[1]
    mask = torch.cat([batch["qmask"], torch.ones_like(response)], dim=1)
    positions = gpt.positions_of(mask)
    gm = batch["gen_mask"]
    count = gm.float().sum().clamp(min=1)
    old_lp, old_v = batch["logprobs"], batch["values"]
    adv, returns = gae(old_v, batch["rewards"], gm, method["gamma"],
                       method["lam"])
    adv = whiten(adv, gm)
    get = params.__getitem__
    head = {k: params[f"v_head.{k}"] for k in ("w1", "b1", "w2", "b2")}
    out = {"losses": []}

    def block_loss(b):
        h = gpt.trunk(get, cfg, None, mask[b], prec,
                      layers=range(L - k_top, L), h=batch["h_split"][b],
                      positions=positions[b])
        hn = model.final_norm(get, cfg, h)[:, P - 1:-1]
        logits = model.lm_logits(get, cfg, hn, prec)
        lp = torch.gather(torch.log_softmax(logits, -1), -1,
                          response[b, :, None].long())[..., 0]
        v = gpt.head(head, hn, prec)[..., 0]
        cv = method["cliprange_value"]
        ov, m = old_v[b], gm[b].float()
        v_clip = torch.clamp(v, ov - cv, ov + cv)
        vf = 0.5 * (torch.maximum((v - returns[b]) ** 2,
                                  (v_clip - returns[b]) ** 2) * m).sum()
        ratio = torch.exp(lp - old_lp[b])
        c = method["cliprange"]
        pg = (torch.maximum(-adv[b] * ratio, -adv[b] * torch.clamp(
            ratio, 1 - c, 1 + c)) * m).sum()
        return (pg + method["vf_coef"] * vf) / count

    with gpt.exact_float32():
        for step in range(steps):
            grads = [torch.zeros_like(params[n]) for n in names]
            total = 0.0
            for s in range(0, query.shape[0], rows_per_block):
                loss = block_loss(slice(s, s + rows_per_block))
                parts = torch.autograd.grad(loss, [params[n] for n in names])
                for g, p in zip(grads, parts):
                    g.add_(p)
                total += float(loss.detach())
            out["losses"].append(total)
            clipped = opt.step(grads, train["learning_rate_init"])
            if step == 0:
                out["grad_tensors"] = dict(zip(names, clipped))
    out["change"] = {n: params[n].detach() - start[n] for n in names}
    return out


def rows_of(tokens: np.ndarray, wanted: np.ndarray) -> List[int]:
    """Index in ``tokens`` [N, G] of each row of ``wanted`` [B, G]."""
    index = {row.tobytes(): i for i, row in enumerate(tokens)}
    return [index[row.tobytes()] for row in wanted]
