"""Offline (ILQL) pipeline and rollout storage (port of
trlx_tpu.pipeline.offline_pipeline).

:class:`OfflinePipeline` is the eval-prompt dataset (strings or
pre-tokenized id rows); :class:`OfflineRolloutStorage` holds
(input_ids, attention_mask, rewards) triples and yields right-padded
:class:`ILQLBatch` es of numpy arrays, padded with the eos id. Collation
goes through the threaded C++ ``pad_collate`` of
:mod:`trlx_tpu_torch.native` when it is available, else the numpy loop,
with the same result.
"""

from typing import Iterator, List

import numpy as np

from trlx_tpu_torch.data.ilql_types import ILQLBatch, ILQLElement
from trlx_tpu_torch.pipeline import (
    BasePipeline,
    BaseRolloutStore,
    batch_iterator,
    register_datapipeline,
)


@register_datapipeline("OfflinePipeline")
class OfflinePipeline(BasePipeline):
    """Eval prompts: a list of strings, or an array / list of token-id
    rows."""

    def __init__(self, texts=None):
        super().__init__()
        self.texts = list(texts) if texts is not None else []

    def __getitem__(self, index: int):
        return self.texts[index]

    def __len__(self) -> int:
        return len(self.texts)

    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = False) -> Iterator:
        return batch_iterator(len(self), batch_size, shuffle, seed,
                              lambda idx: [self.texts[i] for i in idx],
                              drop_last=drop_last)


class OfflineRolloutStorage(BaseRolloutStore):
    """Pre-tokenized offline samples: per row int32 ids and mask
    [length] and float32 rewards [length - 1]."""

    def __init__(self, input_ids: List, attention_mask: List, rewards: List):
        super().__init__()
        self.input_ids = [np.asarray(x, np.int32) for x in input_ids]
        self.attention_mask = [np.asarray(x, np.int32)
                               for x in attention_mask]
        self.rewards = [np.asarray(x, np.float32) for x in rewards]

    def __getitem__(self, index: int) -> ILQLElement:
        return ILQLElement(self.input_ids[index],
                           self.attention_mask[index], self.rewards[index])

    def __len__(self) -> int:
        return len(self.input_ids)

    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0, eos_token_id: int = 0,
                      drop_last: bool = False,
                      pad_to_multiple: int = 1) -> Iterator:
        """Batches padded to the store-global longest row (rounded up to
        ``pad_to_multiple``): ids with ``eos_token_id``, masks with 0,
        rewards to ``maxlen - 1`` with 0."""
        maxlen = max(len(x) for x in self.input_ids)
        maxlen = -(-maxlen // pad_to_multiple) * pad_to_multiple

        def fetch(idx):
            from trlx_tpu_torch import native

            if native.available():
                # threaded C++ collation (trlx_tpu_torch/csrc/hostdata.cpp)
                ids, mask, rewards = native.pad_collate(
                    [self.input_ids[i] for i in idx],
                    [self.attention_mask[i] for i in idx],
                    [self.rewards[i] for i in idx],
                    maxlen, eos_token_id,
                )
                return ILQLBatch(ids, mask, rewards)
            ids = np.full((len(idx), maxlen), eos_token_id, np.int32)
            mask = np.zeros((len(idx), maxlen), np.int32)
            rewards = np.zeros((len(idx), maxlen - 1), np.float32)
            for row, i in enumerate(idx):
                n = len(self.input_ids[i])
                ids[row, :n] = self.input_ids[i]
                mask[row, :n] = self.attention_mask[i]
                rewards[row, :n - 1] = self.rewards[i]
            return ILQLBatch(ids, mask, rewards)

        return batch_iterator(len(self), batch_size, shuffle, seed, fetch,
                              drop_last=drop_last)
