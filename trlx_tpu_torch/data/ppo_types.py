"""PPO rollout containers (port of trlx_tpu.data.ppo_types), as
dataclasses of tensors.

``logprobs`` are the gathered per-token logprobs of the response
[response_size]; ``response_mask`` marks real response tokens (pads
after eos are 0); ``query_mask`` is the prompt attention mask the
rollout used (left padding makes it non-trivial, so stacking requires
it).
"""

from dataclasses import dataclass, fields
from typing import Callable, List, Optional

import torch


@dataclass
class PPORLElement:
    """One rollout record (all [query_size] or [response_size])."""

    query_tensor: torch.Tensor
    response_tensor: torch.Tensor
    logprobs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    response_mask: Optional[torch.Tensor] = None
    query_mask: Optional[torch.Tensor] = None


@dataclass
class PPORLBatch:
    """A stacked batch of rollouts: [batch, query_size] query tensors and
    masks, [batch, response_size] everything else."""

    query_tensors: torch.Tensor
    response_tensors: torch.Tensor
    logprobs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    response_masks: torch.Tensor
    query_masks: torch.Tensor

    def __len__(self) -> int:
        return int(self.query_tensors.shape[0])

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "PPORLBatch":
        """A new batch with ``fn`` applied to every field (indexing,
        device moves)."""
        return PPORLBatch(*(fn(getattr(self, f.name)) for f in fields(self)))

    @classmethod
    def cat(cls, batches: List["PPORLBatch"]) -> "PPORLBatch":
        """Concatenate batches along the batch axis."""
        return cls(*(torch.cat([getattr(b, f.name) for b in batches])
                     for f in fields(cls)))

    @classmethod
    def stack(cls, elements) -> "PPORLBatch":
        def resp_mask_of(e):
            # all ones: every generated token is real (fixed-length
            # generation)
            if e.response_mask is not None:
                return e.response_mask
            return torch.ones_like(e.response_tensor, dtype=torch.int32)

        def query_mask_of(e):
            if e.query_mask is None:
                raise ValueError(
                    "PPORLElement.query_mask is required to stack a batch: "
                    "store the prompt attention mask the rollout used "
                    "(left-padded prompts make it non-trivial)."
                )
            return e.query_mask

        return cls(
            query_tensors=torch.stack([e.query_tensor for e in elements]),
            response_tensors=torch.stack(
                [e.response_tensor for e in elements]),
            logprobs=torch.stack([e.logprobs for e in elements]),
            values=torch.stack([e.values for e in elements]),
            rewards=torch.stack([e.rewards for e in elements]),
            response_masks=torch.stack([resp_mask_of(e) for e in elements]),
            query_masks=torch.stack([query_mask_of(e) for e in elements]),
        )

    def unstack(self) -> List[PPORLElement]:
        return [
            PPORLElement(
                self.query_tensors[i], self.response_tensors[i],
                self.logprobs[i], self.values[i], self.rewards[i],
                self.response_masks[i], self.query_masks[i],
            )
            for i in range(len(self))
        ]
