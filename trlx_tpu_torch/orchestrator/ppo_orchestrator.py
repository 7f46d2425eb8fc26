"""PPO orchestrator — the online rollout engine (port of
trlx_tpu.orchestrator.ppo_orchestrator).

Per chunk of ``chunk_size`` prompts: the trainer's ``rollout`` selects
the prompts from the device-resident bank, generates, and scores them in
one shared-trunk forward (policy and reference logprobs, values, the
KL-penalty rewards); the task score comes from the user's host
``reward_fn(List[str]) -> scores`` on the decoded sequences or, for a
device reward model (``is_device_reward``, trlx_tpu_torch.models.reward),
from its ``score_tokens`` on the sequences themselves, with no decode;
the score lands on each row's last real response token; the chunk goes
into the store. Then the adaptive KL controller updates from the
measured mean KL. The prompt iteration is the JAX package's
(``batch_iterator`` with a seed that advances each pass over the
prompts).

``start_experience`` enqueues every device computation of the
experience against one policy snapshot — each chunk's generation, its
scoring (policy and reference logprobs, values, KL rewards) and, for a
device reward model, its scores — so under ``train.continuous_rollouts``
the updates the trainer queues afterwards cannot change it.
``finish_experience`` harvests the chunks inside a ``rollout`` phase
(telemetry span + supervisor heartbeat; the ``rollout`` chaos seam fires
at its entry) that closes once the chunks' results are on the host, with
one heartbeat per harvested chunk. The harvest is double-buffered, as
trlx_tpu's: chunk i + 1's device-to-host copies (sequences, per-sequence
KL, device scores; non-blocking into pinned buffers, one CUDA event a
chunk) start before chunk i's host decode and ``reward_fn``, so the host
work overlaps the next transfer (:class:`HostHarvest`). The host reward
goes through ``retry_call`` (``train.host_retries``, a bounded worker
under ``train.host_call_timeout``, the ``reward_fn`` chaos seam) in a
nested ``reward_fn`` phase; a device reward model's scores stay on the
card for the rewards and reach the host only for the statistics.

Each chunk's work is split into telemetry phases, each with the chunk's
index and row count (``chunk``, ``rows``): the device phases
``rollout/prefill`` and ``rollout/decode`` (``generate``),
``rollout/score`` (the trainer's ``rollout``) and
``rollout/reward_model`` (:meth:`PPOOrchestrator.device_scores`), and
the host phase ``rollout/harvest`` (waiting on the chunk's copies, the
decode and ``reward_fn`` or the device scores, ``push_to_store``).
"""

from typing import Callable, List, Sequence

import numpy as np
import torch

from trlx_tpu_torch import supervisor, telemetry
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.orchestrator import Orchestrator, register_orchestrator
from trlx_tpu_torch.parallel import broadcast_host_floats
from trlx_tpu_torch.pipeline import batch_iterator
from trlx_tpu_torch.supervisor import chaos, seam_timeout
from trlx_tpu_torch.utils import Clock
from trlx_tpu_torch.utils.faults import retry_call
from trlx_tpu_torch.utils.profiling import annotate


class HostHarvest:
    """Double-buffered device-to-host copies of each chunk's host-bound
    tensors. Two slots of host buffers (pinned when the tensors are on
    the card) serve the chunks in turn: :meth:`start` enqueues chunk i's
    copies into slot i % 2 (non-blocking, then one CUDA event),
    :meth:`wait` waits for that event and returns numpy views of the
    slot. The caller starts chunk i + 1 only after it is done with chunk
    i - 1's views, so a slot is never refilled before its copies have
    landed and its consumer has finished. On the CPU the same slots
    receive plain copies."""

    def __init__(self, trees: Sequence[Sequence[torch.Tensor]]):
        self.trees = trees
        self.slots: List = [None, None]
        self.events: List = [None, None]

    def start(self, i: int) -> None:
        tree, k = self.trees[i], i % 2
        pin = tree[0].is_cuda
        if self.slots[k] is None:  # every chunk has the same shapes
            self.slots[k] = [torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=pin) for t in tree]
        slot = self.slots[k]
        for dst, src in zip(slot, tree):
            dst.copy_(src, non_blocking=pin)
        if pin:
            self.events[k] = torch.cuda.Event()
            self.events[k].record()

    def wait(self, i: int):
        k = i % 2
        if self.events[k] is not None:
            self.events[k].synchronize()
        return tuple(t.numpy() for t in self.slots[k])


@register_orchestrator("PPOOrchestrator")
class PPOOrchestrator(Orchestrator):
    def __init__(self, model, pipeline, reward_fn: Callable,
                 metric_fn: Callable = None, chunk_size: int = 512):
        super().__init__(pipeline, model)
        self.chunk_size = chunk_size
        self.reward_fn = reward_fn
        self.metric_fn = metric_fn
        self._idx_loader = None
        self._loader_seed = 0
        self._bank = None  # device-resident (tokens, masks) prompt bank
        self.rl_model.set_orchestrator(self, reward_fn)
        self.clock = Clock()

    def _prompt_bank(self):
        """The tokenized prompt set, moved to the trainer's device once."""
        if self._bank is None:
            self._bank = self.rl_model._to_device(
                (torch.as_tensor(np.asarray(self.pipeline.tokens, np.int32)),
                 torch.as_tensor(np.asarray(self.pipeline.masks, np.int32)))
            )
        return self._bank

    def _next_idx(self) -> np.ndarray:
        """Next chunk of prompt indices: shuffled without replacement, a
        fresh seed for each pass over the prompts."""
        if len(self.pipeline) < self.chunk_size:
            raise ValueError(
                f"prompt pipeline has {len(self.pipeline)} prompts but "
                f"chunk_size is {self.chunk_size}; provide at least "
                f"chunk_size prompts (or lower chunk_size)"
            )
        if self._idx_loader is None:
            self._idx_loader = batch_iterator(
                len(self.pipeline), self.chunk_size, True,
                self._loader_seed, lambda idx: idx,
            )
        try:
            return next(self._idx_loader)
        except StopIteration:
            self._loader_seed += 1
            self._idx_loader = None
            return self._next_idx()

    def score(self, texts) -> np.ndarray:
        """The user reward callback on decoded query + response texts, with
        ``train.host_retries`` retries and, under
        ``train.host_call_timeout`` (or ``stall_timeout``), each attempt
        bounded: a HUNG scoring service times out and is retried."""
        t = self.rl_model.config.train
        # every process must train on the same rewards: process 0's
        return broadcast_host_floats(retry_call(
            self.reward_fn, texts, retries=t.host_retries,
            backoff=t.host_retry_backoff, timeout=seam_timeout(t),
            seam="reward_fn", label="reward_fn"))

    def make_experience(self, num_rollouts: int = 1024, iter_count: int = 0):
        """Fill the trainer's store with ``num_rollouts`` scored rollouts,
        rounded up to whole chunks (with a warning). Generation and
        scoring run inside the ``rollout`` phase too: eager PyTorch runs
        them in ``start_experience``."""
        with annotate("rollout"):
            chaos.maybe_inject("rollout")
            return self._finish_experience(
                self.start_experience(num_rollouts, iter_count))

    def start_experience(self, num_rollouts: int, iter_count: int = 0):
        """Enqueue every chunk's device work (generation, scoring, device
        reward) against the policy as of this call; the handle for
        :meth:`finish_experience`. All chunks go at once, so one
        experience batch comes from one policy snapshot even when the
        trainer queues updates before the harvest."""
        import warnings

        if num_rollouts <= 0:
            raise ValueError(f"make_experience: num_rollouts must be "
                             f"positive, got {num_rollouts}")
        n_chunks = -(-num_rollouts // self.chunk_size)
        if n_chunks * self.chunk_size != num_rollouts:
            warnings.warn(
                f"make_experience: num_rollouts={num_rollouts} is not a "
                f"multiple of chunk_size={self.chunk_size}; producing "
                f"{n_chunks * self.chunk_size} rollouts", stacklevel=2,
            )
        bank_tokens, bank_mask = self._prompt_bank()
        device_reward = getattr(self.reward_fn, "is_device_reward", False)
        pendings, scores = [], []
        for i in range(n_chunks):
            pending = self.rl_model.rollout(bank_tokens, bank_mask,
                                            self._next_idx(), chunk=i)
            pendings.append(pending)
            if device_reward:
                out, query = pending[0], pending[1]
                with telemetry.device_phase("rollout/reward_model",
                                            chunk=i,
                                            rows=int(query.shape[0])):
                    scores.append(self.device_scores(out, query.shape[1]))
        return {"pendings": pendings, "device_scores": scores,
                "n_chunks": n_chunks}

    def finish_experience(self, handle):
        """Score, finalize and store every dispatched chunk inside a
        ``rollout`` phase (each host reward call in a nested
        ``reward_fn`` phase), then update the KL controller."""
        with annotate("rollout"):
            chaos.maybe_inject("rollout")
            return self._finish_experience(handle)

    def device_scores(self, out, prompt_len: int) -> torch.Tensor:
        """A device reward model's scores for one chunk, on the device.
        The mask is the prompt's with ``gen_mask`` spliced in for the
        response: ``out.attention_mask`` keeps post-eos pads at 1 (cache
        validity), and a row that ended early must be summarised at its
        last real token, not at a trailing pad."""
        mask = torch.cat([out.attention_mask[:, :prompt_len],
                          out.gen_mask.to(out.attention_mask.dtype)], dim=1)
        return self.reward_fn.score_tokens(out.sequences, mask)

    def _finish_experience(self, handle):
        trainer = self.rl_model
        pendings, device_scores = handle["pendings"], handle["device_scores"]
        n_chunks = handle["n_chunks"]
        harvest = HostHarvest([
            (p[0].sequences, p[6]) + ((device_scores[i].float(),)
                                      if device_scores else ())
            for i, p in enumerate(pendings)])
        if pendings:
            harvest.start(0)
        all_kls, all_scores = [], []
        for i, pending in enumerate(pendings):
            out, query, qmask, logprobs, values, kl_rewards, seq_kl = pending
            with telemetry.span("rollout/harvest", chunk=i,
                                rows=int(query.shape[0])):
                host = harvest.wait(i)
                # chunk i + 1's copies run while the host decodes and
                # scores chunk i (chunk i - 1's buffers are free by now)
                if i + 1 < n_chunks:
                    harvest.start(i + 1)
                sequences, seq_kl_host = host[0], host[1]
                if device_scores:
                    scores = device_scores[i]
                    all_scores.append(np.array(host[2], np.float32))
                else:
                    texts = trainer.tokenizer.batch_decode(
                        sequences, skip_special_tokens=True)
                    with annotate("reward_fn"):
                        scores = self.score(texts)
                    all_scores.append(scores)
                rewards = trainer.finalize_rewards(kl_rewards, out.gen_mask,
                                                   scores)
                all_kls.append(float(seq_kl_host.mean()))
                trainer.push_to_store(PPORLBatch(
                    query_tensors=query,
                    response_tensors=out.gen_tokens,
                    logprobs=logprobs,
                    values=values,
                    rewards=rewards,
                    response_masks=out.gen_mask,
                    query_masks=qmask,
                ))
            self.clock.tick(out.sequences.shape[0])
            # chunk-to-chunk progress resets the watchdog's timer
            supervisor.beat()
        trainer.post_rollout_kl_update(float(np.mean(all_kls)),
                                       n_chunks * self.chunk_size)
        return {
            "rollouts": n_chunks * self.chunk_size,
            "mean_score": float(np.concatenate(all_scores).mean()),
            "mean_kl": float(np.mean(all_kls)),
            "exp_time": self.clock.get_stat(self.chunk_size),
            "samples_per_sec": self.clock.samples_per_second(),
        }
