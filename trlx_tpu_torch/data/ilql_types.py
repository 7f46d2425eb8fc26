"""ILQL offline-sample containers (port of trlx_tpu.data.ilql_types).

A sample is token ids, an attention mask and per-token rewards; a batch
stacks them right-padded into fixed-shape arrays. Fields stay numpy on
the host; :meth:`ILQLBatch.map` moves or indexes every field at once
(e.g. to torch tensors on the trainer's device).
"""

from dataclasses import dataclass, fields
from typing import Callable

import numpy as np


@dataclass
class ILQLElement:
    """One offline sample.

    :param input_ids: token ids, [length]
    :param attention_mask: 1 for real tokens, 0 for padding, [length]
    :param rewards: per-token rewards (terminal return on the last real
        slot), [length - 1]
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    rewards: np.ndarray


@dataclass
class ILQLBatch:
    """A stacked batch of offline samples.

    :param input_ids: [batch, length]
    :param attention_mask: [batch, length]
    :param rewards: [batch, length - 1]
    """

    input_ids: np.ndarray
    attention_mask: np.ndarray
    rewards: np.ndarray

    def __len__(self) -> int:
        return int(self.input_ids.shape[0])

    def map(self, fn: Callable) -> "ILQLBatch":
        """A new batch with ``fn`` applied to every field."""
        return ILQLBatch(*(fn(getattr(self, f.name)) for f in fields(self)))

    @classmethod
    def stack(cls, elements, pad_token_id: int = 0) -> "ILQLBatch":
        """Right-pad ``elements`` to the longest one: ids with
        ``pad_token_id``, masks and rewards with 0."""
        maxlen = max(len(e.input_ids) for e in elements)

        def pad(x, fill):
            out = np.full((len(elements), maxlen), fill,
                          dtype=np.asarray(x[0]).dtype)
            for i, row in enumerate(x):
                out[i, :len(row)] = row
            return out

        return cls(
            input_ids=pad([e.input_ids for e in elements], pad_token_id),
            attention_mask=pad([e.attention_mask for e in elements], 0),
            rewards=pad([e.rewards for e in elements], 0.0).astype(
                np.float32),
        )
