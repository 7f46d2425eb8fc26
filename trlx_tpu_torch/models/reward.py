"""Learned reward model on the trainer's device (port of
trlx_tpu.models.reward).

``RewardModel`` is a trunk plus a scalar head; ``score`` reads the
hidden state of each row's last real token — the HIGHEST index whose
mask is 1, which is right under left and right padding alike (``sum -
1`` is wrong under left padding) — through the dense blocks, as the
reference's ``apply_blocks`` is dense. ``DeviceRewardModel`` holds a
deep copy of its parameters on the device (the trainer it is usually
built from updates its own in place), scores token sequences there
(``score_tokens``, a device tensor the PPO orchestrator folds into the
rollout) and also answers the host contract ``reward_fn(List[str])``.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models.heads import head_apply, init_head_params
from trlx_tpu_torch.models.params import _init_base_numpy, reward_to_torch
from trlx_tpu_torch.models.transformer import (
    apply_blocks,
    causal_mask_bias,
    embed_tokens,
    layer_norm,
    positions_from_mask,
)
from trlx_tpu_torch.utils import resolve_device

Params = Dict[str, Any]


def _concat_segments(segments):
    """Stacked block segments (numpy or torch) as one stacked tree, each
    leaf in the first segment's dtype."""
    first = segments[0]
    if isinstance(first, dict):
        return {k: _concat_segments([seg[k] for seg in segments])
                for k in first}
    if torch.is_tensor(first):
        from trlx_tpu_torch.parallel.sharding import whole

        return torch.cat([whole(x).detach().to(first.dtype)
                          for x in segments])
    return np.concatenate([np.asarray(x, first.dtype) for x in segments])


@dataclass(frozen=True)
class RewardModel:
    """Trunk + scalar head; ``score`` reads the last real token's hidden
    state (the sequence summary learned reward models train with)."""

    spec: ModelSpec
    compute_dtype: Any = torch.bfloat16

    def init(self, seed: int = 0) -> Params:
        """A random numpy tree (float32) with the reference's init scheme,
        drawn from a numpy generator seeded with ``seed``."""
        rng = np.random.default_rng(seed)
        embed, blocks, ln_f = _init_base_numpy(self.spec, rng)
        return {"embed": embed, "blocks": blocks, "ln_f": ln_f,
                "r_head": init_head_params(rng, self.spec.d_model, 1)}

    def from_trunk(self, embed: Params, blocks, ln_f: Params,
                   head_seed: int = 1) -> Params:
        """Params from an existing trunk with a fresh scalar head (seeded
        numpy draw). ``blocks`` is one stacked tree or a tuple of
        segments (the hydra policies' ``all_blocks``), concatenated here
        once; ``embed`` loses any ``lm_head``."""
        if isinstance(blocks, (list, tuple)):
            blocks = _concat_segments(list(blocks))
        embed = {k: v for k, v in embed.items() if k != "lm_head"}
        rng = np.random.default_rng(head_seed)
        return {"embed": embed, "blocks": blocks, "ln_f": ln_f,
                "r_head": init_head_params(rng, self.spec.d_model, 1)}

    @torch.no_grad()
    def score(self, params: Params, tokens: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
        """[B] float32 rewards for (left- or right-padded) sequences."""
        positions = positions_from_mask(attention_mask)
        h = embed_tokens(params["embed"], self.spec, tokens, positions,
                         self.compute_dtype)
        h = apply_blocks(params["blocks"], self.spec, h,
                         causal_mask_bias(attention_mask), positions)
        h = layer_norm(params["ln_f"], h, self.spec.layer_norm_epsilon)
        T = attention_mask.shape[-1]
        last = T - 1 - torch.argmax(attention_mask.flip(-1).to(torch.int32),
                                    dim=-1)
        rows = torch.arange(h.shape[0], device=h.device)
        return head_apply(params["r_head"], h[rows, last])[:, 0]


class DeviceRewardModel:
    """A reward model on the trainer's device, usable wherever a
    ``reward_fn`` is:

    - ``score_tokens(tokens, mask)`` scores on the device and returns a
      device [B] float32 tensor;
    - ``__call__(texts)`` — the host contract: tokenize, score, return
      floats (eval paths use it).

    The parameters are ALWAYS deep-copied onto ``device`` (default: the
    card, or pass ``device="cpu"``): a trainer updates its own tensors in
    place, and a reward model sharing them would drift with the policy.

    With a ``mesh`` (trlx_tpu_torch.parallel) the copy lives on the mesh,
    sharded by trlx_tpu's leaf rules; each process scores its rows of a
    batch with the parameters gathered on use (a batch dp * fsdp does not
    divide is padded with its last row) and every process gets the whole
    batch's scores.
    """

    is_device_reward = True

    def __init__(self, model: RewardModel, params: Params, tokenizer,
                 max_length: int = 512, device: Optional[str] = None,
                 mesh=None):
        self.model = model
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.device = resolve_device(device)
        if mesh is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = mesh
        self.params = reward_to_torch(params, self.device, mesh=mesh)
        self._gathered = {}

    def score_tokens(self, tokens, attention_mask) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        attention_mask = torch.as_tensor(attention_mask, device=self.device)
        if self.mesh is None:
            return self.model.score(self.params, tokens, attention_mask)
        from trlx_tpu_torch.parallel.sharding import (
            gather_rows,
            n_data,
            rows_of,
            unshard_tree,
        )

        n = tokens.shape[0]
        pad = (-n) % n_data(self.mesh)
        if pad:
            tokens, attention_mask = (torch.cat([x, x[-1:].expand(
                pad, *x.shape[1:])]) for x in (tokens, attention_mask))
        scores = self.model.score(
            unshard_tree(self.params, into=self._gathered),
            rows_of(tokens, self.mesh), rows_of(attention_mask, self.mesh))
        return gather_rows(scores, self.mesh)[:n]

    def __call__(self, texts):
        enc = self.tokenizer(list(texts), max_length=self.max_length,
                             padding="max_length", truncation=True)
        scores = self.score_tokens(
            torch.as_tensor(np.asarray(enc["input_ids"], np.int32)),
            torch.as_tensor(np.asarray(enc["attention_mask"], np.int32)))
        return scores.float().cpu().numpy().tolist()
