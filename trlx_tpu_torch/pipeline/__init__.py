"""Pipeline / rollout-store bases and registry (port of
trlx_tpu.pipeline). Loaders yield stacked batches; ``batch_iterator``
shuffles with ``np.random.default_rng(seed)`` exactly as the JAX package
does, so both packages visit batches in the same order."""

from abc import abstractmethod
from typing import Any, Callable, Dict, Iterator

import numpy as np

from trlx_tpu_torch.utils.registry import BuiltinLoader, make_register

_DATAPIPELINE: Dict[str, type] = {}
_load_builtins = BuiltinLoader(("trlx_tpu_torch.pipeline.ppo_pipeline",
                                "trlx_tpu_torch.pipeline.offline_pipeline"))

#: Decorator registering a pipeline class under a string name.
register_datapipeline = make_register(_DATAPIPELINE)


class BasePipeline:
    """Abstract prompt dataset."""

    def __init__(self, path: str = "dataset"):
        self.path = path

    @abstractmethod
    def __getitem__(self, index: int):
        raise NotImplementedError

    @abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = True) -> Iterator:
        """Yield stacked batches of prompts."""
        raise NotImplementedError


class BaseRolloutStore:
    """Abstract experience store; ``capacity`` (> 0) bounds it."""

    def __init__(self, capacity: int = -1):
        self.capacity = capacity
        self.history: Any = None

    @abstractmethod
    def push(self, exps) -> None:
        raise NotImplementedError

    @abstractmethod
    def __getitem__(self, index: int):
        raise NotImplementedError

    @abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def create_loader(self, batch_size: int, shuffle: bool = False,
                      seed: int = 0) -> Iterator:
        raise NotImplementedError


def batch_iterator(n: int, batch_size: int, shuffle: bool, seed: int,
                   fetch: Callable[[np.ndarray], Any],
                   drop_last: bool = True) -> Iterator:
    """Shared index-batching loop: yields ``fetch(indices)`` per batch."""
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield fetch(idx[start:start + batch_size])
