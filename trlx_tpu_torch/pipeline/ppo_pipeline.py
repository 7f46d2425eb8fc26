"""PPO prompt pipeline and rollout storage (port of
trlx_tpu.pipeline.ppo_pipeline). Prompts are tokenized up front to the
fixed ``input_size`` with left padding; the store keeps stacked
:class:`PPORLBatch` chunks (on the trainer's device) and gathers a
minibatch by index."""

from typing import Iterator, List, Optional

import numpy as np
import torch

from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.pipeline import (
    BasePipeline,
    BaseRolloutStore,
    batch_iterator,
    register_datapipeline,
)


@register_datapipeline("PPOPipeline")
class PPOPipeline(BasePipeline):
    """Prompt dataset: ``tokens`` and ``masks`` int32 [N, input_size]
    (numpy, host side)."""

    def __init__(self, prompts: List[str], tokenizer, config):
        super().__init__()
        self.tokenizer = tokenizer
        self.input_size = config.train.input_size
        enc = tokenizer(prompts, max_length=self.input_size,
                        padding="max_length", truncation=True)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        if ids.shape[1] > self.input_size:  # tokenizers that do not truncate
            ids = ids[:, -self.input_size:]
            mask = mask[:, -self.input_size:]
        self.tokens = ids
        self.masks = mask
        self.text = prompts

    def __getitem__(self, index: int):
        return self.tokens[index], self.masks[index]

    def __len__(self) -> int:
        return len(self.tokens)

    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = True) -> Iterator:
        return batch_iterator(
            len(self), batch_size, shuffle, seed,
            lambda idx: (self.tokens[idx], self.masks[idx]),
            drop_last=drop_last,
        )


class PPORolloutStorage(BaseRolloutStore):
    """Append-only (optionally capacity-bounded) store of rollout
    chunks."""

    def __init__(self, capacity: int = -1):
        super().__init__(capacity)
        self.history: List[PPORLBatch] = []

    def push(self, exps: PPORLBatch) -> None:
        self.history.append(exps)
        if self.capacity > 0:
            total = sum(len(b) for b in self.history)
            while total > self.capacity and len(self.history) > 1:
                total -= len(self.history.pop(0))

    def clear_history(self) -> None:
        self.history = []

    def _stacked(self) -> Optional[PPORLBatch]:
        if not self.history:
            return None
        if len(self.history) == 1:
            return self.history[0]
        return PPORLBatch.cat(self.history)

    def __getitem__(self, index: int):
        return self._stacked().unstack()[index]

    def __len__(self) -> int:
        return sum(len(b) for b in self.history)

    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0) -> Iterator:
        data = self._stacked()
        if data is None:
            return iter(())

        def fetch(idx):
            rows = torch.as_tensor(idx, device=data.query_tensors.device)
            return data.map(lambda x: x[rows])

        return batch_iterator(len(data), batch_size, shuffle, seed, fetch)
