"""Offline orchestrator: the one-shot ILQL dataset builder (port of
trlx_tpu.orchestrator.offline_orchestrator).

Tokenizes text samples with the trainer's ``tokenize`` (token rows pass
as they are), builds each row's mask with the terminal slot zeroed,
scores the rows once with ``reward_fn`` and whitens the returns
(population std + 1e-30), puts each return on the row's last reward
slot, and installs ``train_store``, ``eval_pipeline``, ``reward_fn`` and
``stats_fn`` on the trainer. One process: the returns are a plain
float32 array (the JAX package broadcasts them from process 0).
"""

import numpy as np

from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.parallel import broadcast_host_floats
from trlx_tpu_torch.pipeline.offline_pipeline import (
    OfflinePipeline,
    OfflineRolloutStorage,
)


@register_orchestrator("OfflineOrchestrator")
class OfflineOrchestrator(Orchestrator):
    def __init__(self, model, train_samples, eval_prompts, reward_fn,
                 stats_fn=None):
        super().__init__(None, model)
        self.model = model
        if isinstance(train_samples[0], str):
            train_samples = model.tokenize(train_samples)["input_ids"]
        train_samples = [list(map(int, row)) for row in train_samples]

        # every slot real except the terminal one: the loss reads the
        # mask as the non-terminal mask over state positions
        attention_mask = []
        for row in train_samples:
            m = np.ones(len(row), np.int32)
            m[-1] = 0
            attention_mask.append(m)

        # every process trains on process 0's returns
        returns = broadcast_host_floats(reward_fn(train_samples))
        returns = (returns - returns.mean()) / (returns.std() + 1e-30)

        rewards = []
        for row, G in zip(train_samples, returns):
            r = np.zeros(len(row) - 1, np.float32)
            r[-1] = G
            rewards.append(r)

        model.train_store = OfflineRolloutStorage(train_samples,
                                                  attention_mask, rewards)
        model.store = model.train_store
        model.eval_pipeline = OfflinePipeline(eval_prompts)
        model.reward_fn = reward_fn
        model.stats_fn = stats_fn

    def make_experience(self, num_rollouts: int = 0, iter_count: int = 0):
        """Offline: the dataset is built once, in the constructor."""
        return {"rollouts": len(self.model.train_store)}
