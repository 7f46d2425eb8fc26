"""ILQL trainer: the offline train step, the Polyak target sync and
advantage-shifted sampling (port of trlx_tpu.trainers.ilql_trainer).

- ``train_step``: one trunk forward to the post-ln_f hidden state, the
  ILQL loss with every V-wide head chunked over T
  (:func:`ilql_losses_chunked`), the backward and the optimizer
  (``build_optimizer`` with the ramp-up / decay schedule: the lr is 0 at
  step 0). With ``step_events`` a list, each update on the card also
  records CUDA events around those four parts.
- ``learn``: the whole offline dataset is collated once (rows padded to
  the store-global longest) and, below 512 MiB (or
  ``$TRLX_TPU_DATASET_HBM_BYTES``), held on the device, each step
  gathering its rows by index; above it each batch is sliced on the host
  and uploaded. Eval every ``eval_interval`` steps, a target sync every
  ``steps_for_target_q_sync``, stats every ``log_interval``.
- Sampling decodes with the ``extras_fn`` hook of ``generate``: the
  trainer's ``logit_mask`` ([V] or [V, V] indexed by the previous token,
  True = DISALLOWED) masks the logits before ``log_softmax``, then
  ``warp_top_k(pi + beta * (min target Q - V), top_k) / temperature``,
  then a plain categorical draw.

Durability as the PPO trainer's: with ``train.max_bad_steps > 0`` an
update whose loss or grad norm is not finite commits nothing; ``learn``
resumes from ``train.resume_from``, feeds the StepGuard, saves every
``checkpoint_interval`` and stops cleanly on SIGTERM. The run floor is
the PPO trainer's: the run supervisor (``ilql_update``, ``eval`` and
``reward_fn`` phases, walltime, chaos), ``train.tracker``, the telemetry
payload in every emission, ``telemetry.json`` / ``trace.jsonl`` at every
exit and ``$TRLX_TPU_PROFILE_DIR``. The components are
``params`` (zero-size frozen leaves included), ``opt_state``, ``state``
(``iter_count`` and the sampling generator's state) and ``config``.

On a mesh with sp > 1 the store is collated to a multiple of sp
positions and each process runs its chunk of them; the per-position
head statistics, V, the mask and the rewards meet over sp (per-token
scalars, never the [B, T, V] head outputs) and over the rows before the
losses. With pp > 1 the frozen trunk runs the GPipe schedule.

Registered as ``JaxILQLTrainer`` and ``ILQLModel``. With no
``model.model_spec`` the trunk is imported from ``model.model_path``
(``ilql_params_from_trunk``: fresh V and Q heads; a failed load raises).
A mesh with sp and pp both above 1 is refused, as trlx_tpu refuses it
(:func:`trlx_tpu_torch.trainers.check_ported`).
"""

import functools
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.models.generation import GenerationConfig, generate
from trlx_tpu_torch.models.hf_import import ilql_params_from_trunk
from trlx_tpu_torch.models.ilql import ILQLModel as ILQLNet, sync_targets
from trlx_tpu_torch.models.params import ilql_to_torch, init_ilql_numpy
from trlx_tpu_torch.models.transformer import NEG_INF
from trlx_tpu_torch.ops.losses import ilql_losses_chunked
from trlx_tpu_torch.ops.sampling import SamplingParams, warp_top_k
from trlx_tpu_torch.parallel.sharding import (
    gather_rows,
    local_rows,
)
from trlx_tpu_torch.models.policy import resolve_num_unfrozen
from trlx_tpu_torch.pipeline import batch_iterator
from trlx_tpu_torch.supervisor import StallError, chaos, seam_timeout
from trlx_tpu_torch.telemetry.device import timing_event
from trlx_tpu_torch.trainers import (
    BaseRLTrainer,
    _leaves,
    build_optimizer,
    register_trainer,
)
from trlx_tpu_torch.utils import (
    DTYPES,
    Clock,
    rampup_decay_schedule,
    tree_bytes,
)
from trlx_tpu_torch.utils.faults import retry_call
from trlx_tpu_torch.utils.profiling import annotate, maybe_trace
from trlx_tpu_torch.utils.tokenizer import load_tokenizer
from trlx_tpu_torch.utils.trackers import samples_table

#: below this many bytes the collated dataset stays on the device
DATASET_DEVICE_BYTES = 512 * 2**20

#: the parts of an update that ``step_events`` bounds, in order
STEP_PARTS = ("trunk_fwd", "heads_loss_fwd", "backward", "optimizer")


def _mark(events) -> None:
    """Record a timing CUDA event onto ``events`` (None: nothing), through
    the telemetry's one device-timing path
    (trlx_tpu_torch.telemetry.device ``timing_event``)."""
    if events is not None:
        events.append(timing_event())


@register_trainer("JaxILQLTrainer")
@register_trainer("ILQLModel")
class JaxILQLTrainer(BaseRLTrainer):
    """Offline ILQL. ``params`` (optional) is a numpy ILQL tree to start
    from (e.g. ``jax.device_get`` of the JAX trainer's); by default the
    trunk is imported from ``model.model_path`` or, with
    ``model.model_spec``, a random tree is drawn from ``train.seed`` with
    numpy. The
    :class:`OfflineOrchestrator` installs ``train_store``,
    ``eval_pipeline``, ``reward_fn`` and ``stats_fn``."""

    #: in-loop eval rows at most (``evaluate(n=0)`` takes them all)
    EVAL_CAP = 128

    #: a list to have ``train_step`` append, per update on the card, the
    #: CUDA events that bound the :data:`STEP_PARTS` (read their times
    #: after a device sync); None records nothing
    step_events: Optional[list] = None

    def __init__(self, config, train_mode: bool = True, logit_mask=None,
                 mesh=None, device=None, params=None):
        super().__init__(config, train_mode, mesh=mesh, device=device)
        self.iter_count = 0
        self.tokenizer = load_tokenizer(config.model.tokenizer_path)
        self.max_length = config.train.gen_size
        spec, trunk = self._load_or_spec(config)
        m, t = config.method, config.train
        # the memory pre-check: no ref branch, but the Q / V heads are
        # trainable [d, V] tensors with moments and the target-Q copies
        # frozen ones
        n_q = 2 if m.two_qs else 1
        full = resolve_num_unfrozen(
            spec, config.model.num_layers_unfrozen) == spec.n_layer
        self._check_memory_fit(
            spec, torch.float32, ref_branch=False,
            extra_trainable=n_q * spec.d_model * spec.vocab_size
            + spec.d_model,
            extra_frozen=n_q * spec.d_model * spec.vocab_size,
            embed_trainable=full)
        tp = self._tensor_parallel(spec)
        self.net = ILQLNet(
            spec=spec,
            num_layers_unfrozen=config.model.num_layers_unfrozen,
            two_qs=m.two_qs,
            compute_dtype=DTYPES[config.model.compute_dtype],
            remat=t.remat,
            attention_fn=self._train_attention_fn(),
            tp=tp,
            sp=self.sp,
            **self._pp_kwargs(
                spec.n_layer - resolve_num_unfrozen(
                    spec, config.model.num_layers_unfrozen),
                t.batch_size),
        )
        if params is None and trunk is not None:
            params = ilql_params_from_trunk(self.net, *trunk,
                                            np.random.default_rng(t.seed))
        elif params is None:
            params = init_ilql_numpy(spec, config.model.num_layers_unfrozen,
                                     m.two_qs, seed=t.seed)
        self.opt = build_optimizer(t, sched=rampup_decay_schedule(
            t.lr_ramp_steps, t.lr_decay_steps, t.learning_rate_init,
            t.learning_rate_target))
        self.params, self.opt_state = self._shard_model_state(
            ilql_to_torch(params, self.device))
        #: the tree the decode-time heads read (``_extras``): the
        #: trainer's own, or on a mesh its gathered copy
        self._decode_params = self.params
        self.logit_mask = None if logit_mask is None else torch.as_tensor(
            np.asarray(logit_mask), dtype=torch.bool, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(t.seed)

        # installed by OfflineOrchestrator
        self.train_store = None
        self.eval_pipeline = None
        self.reward_fn: Optional[Callable] = None
        self.stats_fn: Optional[Callable] = None
        # analytic FLOPs for throughput/* and MFU; the tokens per sample
        # come from the collated dataset's width in learn()
        self._flops_per_token = telemetry.ilql_train_flops_per_token(
            spec, resolve_num_unfrozen(spec, config.model.num_layers_unfrozen),
            m.two_qs)
        self.maybe_resume()

    def tokenize(self, texts):
        """bos + text + eos per text, truncated to ``train.gen_size``
        tokens (as trlx_tpu does; the byte tokenizer also left-pads every
        row to that width with pad ids, which then count as tokens)."""
        bos = getattr(self.tokenizer, "bos_token", None) or ""
        eos = getattr(self.tokenizer, "eos_token", None) or ""
        return self.tokenizer([bos + x + eos for x in texts],
                              max_length=self.max_length, truncation=True,
                              padding=False)

    # -- update ----------------------------------------------------------- #

    def train_step(self, batch: ILQLBatch) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (tensors on the trainer's device): the
        loss with the V-wide heads chunked over T, backward, optimizer
        step (through the commit gate when ``max_bad_steps > 0``). Returns
        the stats with the pre-clip ``grad_norm`` and, gated,
        ``bad_step``. On a mesh (the batch through ``_put``) the forward and
        the heads run this process's rows (under sp, its chunk of their
        positions) with the parameters gathered on use, and the losses
        the whole batch's statistics."""
        m, net, mesh = self.config.method, self.net, self.mesh
        events = None if self.step_events is None else []
        _mark(events)
        params, gather = self.params, None
        if mesh is not None:
            batch = self._put(batch).map(local_rows)
            params = self._forward_params()
            gather = functools.partial(gather_rows, mesh=mesh)
        h = net.forward_hidden(params, batch.input_ids,
                               batch.attention_mask)
        _mark(events)
        lm_fn, q_fns, tq_fns, v_fn = net.head_fns(params)
        loss, stats = ilql_losses_chunked(
            lm_fn, q_fns, tq_fns, v_fn(h), h, batch.input_ids,
            batch.attention_mask, batch.rewards, m.gamma, m.tau,
            m.cql_scale, m.awac_scale, gather_rows=gather, seq=self.sp)
        _mark(events)
        leaves = _leaves(self.params["trainable"])
        grads = torch.autograd.grad(loss, leaves)
        _mark(events)
        self._apply_update(loss, leaves, grads, stats)
        _mark(events)
        if events is not None:
            self.step_events.append(events)
        return {k: v.detach() for k, v in stats.items()}

    def sync_targets(self) -> None:
        sync_targets(self.params, self.config.method.alpha)

    # -- sampling --------------------------------------------------------- #

    @torch.no_grad()
    def _extras(self, h_normed, logits, prev_tok):
        """The advantage-shifted step distribution: mask, log_softmax,
        + beta * (min target Q - V), top-k, / temperature."""
        m = self.config.method
        if self.logit_mask is not None:
            if self.logit_mask.dim() == 2:
                rows = prev_tok.long().clamp(0, self.logit_mask.shape[0] - 1)
                disallowed = self.logit_mask[rows]
            else:
                disallowed = self.logit_mask[None, :]
            logits = torch.where(disallowed, NEG_INF, logits)
        tq, v = self.net.heads_on_hidden(self._decode_params, h_normed)
        pi = torch.log_softmax(logits, dim=-1)
        return warp_top_k(pi + m.beta * (tq - v), m.top_k) / m.temperature

    def generate(self, query_tokens, query_mask,
                 gen_size: Optional[int] = None):
        eos = getattr(self.tokenizer, "eos_token_id", 0) or 0
        config = GenerationConfig(
            gen_size=gen_size or self.config.train.gen_size,
            # the warping happens in _extras; the sampler draws plainly
            sampling=SamplingParams(do_sample=True),
            eos_token_id=eos, pad_token_id=eos)
        (query, mask), n = self._pad_rows((np.asarray(query_tokens),
                                           np.asarray(query_mask)))
        query, mask = self._put((query, mask))
        params = self._decode_params = self._whole_params()
        embed, ln_f = self.net.head_params_for_decode(params)
        out = generate(
            self.net.spec, self.net.all_blocks(params), embed, ln_f,
            query, mask, self.generator, config,
            compute_dtype=self.net.compute_dtype, extras_fn=self._extras,
            decoder=self.decoder, mesh=self.mesh)
        if out.sequences.shape[0] != n:
            out = type(out)(*(x[:n] for x in out))
        return out

    def act(self, batch):
        query, mask = batch
        out = self.generate(query, mask)
        texts = self.tokenizer.batch_decode(out.sequences.cpu().numpy(),
                                            skip_special_tokens=True)
        return np.asarray(query), out.gen_tokens.cpu().numpy(), texts

    def sample(self, prompts, length: int = None, n_samples: int = None):
        query, mask = self._encode_prompts(prompts)
        return self.generate(query, mask,
                             gen_size=length).sequences.cpu().numpy()

    def _encode_prompts(self, prompts):
        """Strings through the tokenizer (``train.input_size`` or 8
        wide); token-id rows left-padded with id 0, mask 0."""
        if len(prompts) and isinstance(prompts[0], str):
            enc = self.tokenizer(prompts,
                                 max_length=self.config.train.input_size or 8,
                                 padding="max_length", truncation=True)
            return (np.asarray(enc["input_ids"]),
                    np.asarray(enc["attention_mask"]))
        rows = [np.atleast_1d(np.asarray(p, np.int32)) for p in prompts]
        maxlen = max(len(r) for r in rows)
        ids = np.zeros((len(rows), maxlen), np.int32)
        mask = np.zeros((len(rows), maxlen), np.int32)
        for i, r in enumerate(rows):
            ids[i, maxlen - len(r):] = r
            mask[i, maxlen - len(r):] = 1
        return ids, mask

    # -- loop ------------------------------------------------------------- #

    def evaluate(self, n: int = None):
        """Sample from the eval prompts with the advantage-shifted sampler
        and score them (``reward``, a samples table for text prompts, and
        ``stats_fn``'s keys). ``n`` caps the rows: None applies
        :data:`EVAL_CAP`, 0 takes them all."""
        if self.eval_pipeline is None or len(self.eval_pipeline) == 0:
            return {}
        prompts = self.eval_pipeline.texts
        if n is None:
            n = self.EVAL_CAP
        if n:
            prompts = prompts[:n]
        t = self.config.train
        # telemetry span + supervisor phase; it closes after the samples
        # and rewards are on the host
        with annotate("eval"):
            samples = self.sample(prompts)
            sample_lists = [list(map(int, row)) for row in samples]
            logs = {}
            decoded = None
            if len(prompts) and isinstance(prompts[0], str):
                decoded = self.tokenizer.batch_decode(samples)
            if self.reward_fn is not None:
                with annotate("reward_fn"):
                    rewards = np.asarray(retry_call(
                        self.reward_fn,
                        decoded if decoded is not None else sample_lists,
                        retries=t.host_retries, backoff=t.host_retry_backoff,
                        timeout=seam_timeout(t), seam="reward_fn",
                        label="reward_fn (eval)"), np.float32)
                logs["reward"] = float(rewards.mean())
                if decoded is not None:
                    logs["samples_table"] = samples_table(decoded, rewards)
            if self.stats_fn is not None:
                logs.update(self.stats_fn(sample_lists))
        return logs

    def _collate_store(self):
        """The whole store as one batch padded to its longest row (rounded
        up to a multiple of sp, so the positions split evenly) with a
        pad id kept inside the vocabulary, and whether it stays on the
        device."""
        eos = getattr(self.tokenizer, "eos_token_id", 0) or 0
        pad_id = min(eos, self.net.spec.vocab_size - 1)
        n = len(self.train_store)
        sp = 1 if self.sp is None else self.sp.size
        full = next(iter(self.train_store.create_loader(
            n, shuffle=False, eos_token_id=pad_id, pad_to_multiple=sp)))
        limit = int(os.environ.get("TRLX_TPU_DATASET_HBM_BYTES",
                                   DATASET_DEVICE_BYTES))
        return full, tree_bytes(full) <= limit

    def learn(self, log_fn: Callable = None, save_fn=None, eval_fn=None):
        """The ILQL loop over ``epochs`` shuffled passes (the epoch is the
        shuffle seed), stopping at ``total_steps``, or at the first step
        boundary after a SIGTERM or past ``train.max_walltime`` (saving
        first). Each update runs in an ``ilql_update`` phase that closes
        after a device sync. Resumes from ``train.resume_from`` once per
        process; with ``max_bad_steps > 0`` the StepGuard rolls back or
        aborts. Stats go to ``log_fn`` or ``train.tracker`` with the
        telemetry payload; the run supervisor watches the phases, a hung
        host seam past its retry budget becomes a checkpoint and a
        re-raised StallError, and ``telemetry.json`` / ``trace.jsonl``
        land at every exit (the PPO trainer's run floor)."""
        log_fn = self._make_tracker(log_fn)
        clock = Clock()
        self.maybe_resume()  # no-op when already restored at construction
        step_guard = self._make_step_guard(log_fn)
        sup = self._make_supervisor()
        try:
            with maybe_trace(), self._preemption_guard() as guard, sup:
                self._learn_epochs(log_fn, guard, step_guard, clock, sup)
        except StallError:
            self._contain_stall(log_fn)
            raise
        finally:
            self._finish_telemetry("ilql", clock)

    def _learn_epochs(self, log_fn, guard, step_guard, clock, sup) -> None:
        cfg, m = self.config.train, self.config.method
        full, device_resident = self._collate_store()
        self._tokens_per_sample = int(full.input_ids.shape[1])
        if device_resident:
            dataset = full.map(lambda x: torch.as_tensor(x).to(self.device))
        n = len(self.train_store)
        for epoch in range(cfg.epochs):
            # a partial final batch cannot shard over (dp, fsdp)
            for idx in batch_iterator(n, cfg.batch_size, True, epoch,
                                      lambda idx: idx,
                                      drop_last=self.mesh is not None):
                if self.iter_count % cfg.eval_interval == 0:
                    ev = self.evaluate()
                    if ev:
                        log_fn({"iter": self.iter_count, **ev})
                with annotate("ilql_update"):
                    chaos.maybe_inject("ilql_update")
                    if device_resident:
                        rows = torch.as_tensor(idx, device=self.device)
                        batch = dataset.map(lambda x: x[rows])
                    else:
                        batch = full.map(
                            lambda x: torch.as_tensor(x[idx]).to(self.device))
                    stats = self.train_step(batch)
                    self._sync()
                self.iter_count += 1
                clock.tick(len(idx))
                self._observe_step(step_guard, stats)
                if self.iter_count % m.steps_for_target_q_sync == 0:
                    self.sync_targets()
                if self.iter_count % cfg.log_interval == 0:
                    host = {k: float(v) for k, v in stats.items()}
                    sps = clock.samples_per_second()
                    host.update(iter=self.iter_count, epoch=epoch,
                                samples_per_sec=sps)
                    host.update(self._telemetry_stats(sps))
                    log_fn(host)
                saved_now = self.intervals(self.iter_count)["do_save"]
                if saved_now:
                    self.save()
                self._maybe_flush_telemetry()
                if self._preempt(log_fn, guard, just_saved=saved_now,
                                 sup=sup):
                    return
                if self.iter_count >= cfg.total_steps:
                    return

    def get_components(self) -> Dict:
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "state": {"iter_count": self.iter_count,
                      "generator": self._generator_state()},
            "config": self.config.to_nested_dict(),
        }

    def set_components(self, components: Dict) -> None:
        super().set_components(components)
        state = components["state"]
        self.iter_count = int(state["iter_count"])
        self._set_generator_state(state["generator"])
