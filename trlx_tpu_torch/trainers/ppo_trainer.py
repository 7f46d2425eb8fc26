"""PPO trainer: rollout scoring, the train step and the learn loop (port of
trlx_tpu.trainers.ppo_trainer).

- ``rollout`` selects a chunk of prompts from the device-resident bank,
  generates (dense KV-cache decode) and scores the sequences in one
  shared-trunk forward: policy and reference logprobs (chunked over the
  vocabulary head), values and the KL-penalty rewards.
- ``train_step`` runs GAE, advantage whitening, the policy forward, the
  clipped losses and the optimizer update; ``train_multi`` runs
  ``ppo_epochs`` such passes over one minibatch and returns the last
  pass's stats (``bad_step``: the max over the passes).
- the optimizer is :func:`trlx_tpu_torch.trainers.build_optimizer`
  with its default cosine schedule. With ``train.max_bad_steps > 0``
  each update is committed only when its loss and grad norm are finite
  and, with ``train.max_step_kl > 0``, its ``approx_kl`` is within it.
- ``learn`` resumes from ``train.resume_from``, feeds the StepGuard,
  saves every ``checkpoint_interval`` and stops cleanly on SIGTERM; it
  runs under the run supervisor (watchdog, walltime, chaos), logs
  through ``train.tracker`` unless given a ``log_fn``, carries the
  telemetry payload in every emission and, with
  ``$TRLX_TPU_PROFILE_DIR``, exports a torch.profiler trace.
- the components (``get_components``) are ``params``, ``opt_state``,
  ``state`` (``iter_count``, ``epoch``, ``kl_coef`` and the sampling
  generator's state) and ``config``.

Registered as ``JaxPPOTrainer`` and ``AcceleratePPOModel`` so a YAML
resolves to it as it does to trlx_tpu's trainer. With no
``model.model_spec`` the policy is imported from ``model.model_path``
(``hydra_params_from_trunk``; a failed load raises). A mesh with sp
and pp both above 1 is refused, as trlx_tpu refuses it
(:func:`trlx_tpu_torch.trainers.check_ported`).

On a mesh with sp > 1 the scoring and training forwards run on each
process's chunk of positions (``policy.sp``), and the per-token
logprobs and values are gathered over sp before the losses — per-token
scalars, never the [B, T, V] logits; with pp > 1 the frozen trunk runs
the GPipe schedule (``_pp_kwargs``). Rollout decoding stays dense on the
whole trunk, the same rows and tokens on every sp / pp process.

``train.continuous_rollouts``: when the post-epoch refresh will run
(``_will_refresh``, predicted before the epoch's updates), the next
epoch's experience is dispatched against the pre-update parameters
(``rollout_dispatch_stale``) and harvested after the updates
(``rollout_harvest``): one update phase stale, as in trlx_tpu.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.ppo_types import PPORLBatch
from trlx_tpu_torch.models.generation import GenerationConfig, generate
from trlx_tpu_torch.models.hf_import import hydra_params_from_trunk
from trlx_tpu_torch.models.params import hydra_to_torch, init_hydra_numpy
from trlx_tpu_torch.models.policy import (
    HydraPolicy,
    all_blocks,
    head_params_for_decode,
    resolve_num_unfrozen,
)
from trlx_tpu_torch.ops.losses import (
    chunked_label_logprobs,
    gae_advantages,
    kl_penalty_rewards,
    logprobs_from_logits,
    ppo_losses,
    whiten,
)
from trlx_tpu_torch.parallel.sharding import (
    gather_rows,
    local_rows,
    rows_of,
    whole,
)
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.supervisor import StallError, chaos, seam_timeout
from trlx_tpu_torch.trainers import (
    BaseRLTrainer,
    _leaves,
    build_optimizer,
    register_trainer,
)
from trlx_tpu_torch.trainers.kl_controllers import make_kl_controller
from trlx_tpu_torch.utils import DTYPES, Clock
from trlx_tpu_torch.utils.faults import retry_call
from trlx_tpu_torch.utils.profiling import annotate, maybe_trace
from trlx_tpu_torch.utils.tokenizer import load_tokenizer
from trlx_tpu_torch.utils.trackers import generations_table


@register_trainer("JaxPPOTrainer")
@register_trainer("AcceleratePPOModel")
class JaxPPOTrainer(BaseRLTrainer):
    """PPO with a KL penalty against the frozen reference branch.

    ``params`` (optional) is a hydra tree to start from: numpy leaves
    (e.g. the JAX trainer's ``jax.device_get(trainer.params)``), copied
    to the device, or torch leaves, of which those already on the
    trainer's device in their storage dtype are taken over, not copied
    (a 6B tree built on the card); by default the tree is imported from
    ``model.model_path`` or, with ``model.model_spec``, drawn from
    ``train.seed`` with numpy. The orchestrator binds itself and the
    reward through :meth:`set_orchestrator`."""

    def __init__(self, config, train_mode: bool = True, mesh=None,
                 device=None, params=None):
        super().__init__(config, train_mode, mesh=mesh, device=device)
        self.iter_count = 0
        self.epoch = 0
        self.tokenizer = load_tokenizer(config.model.tokenizer_path)
        spec, trunk = self._load_or_spec(config)
        if self.sp is not None:
            T = config.train.input_size + config.train.gen_size
            if T % self.sp.size != 0:
                raise ValueError(
                    f"mesh sp={self.sp.size} requires input_size + gen_size "
                    f"({config.train.input_size} + {config.train.gen_size} "
                    f"= {T}) to be divisible by it (ring attention splits "
                    f"the train-time sequence across sp devices)")
        tp = self._tensor_parallel(spec)
        k = resolve_num_unfrozen(spec, config.model.num_layers_unfrozen)
        self.policy = HydraPolicy(
            spec=spec,
            num_layers_unfrozen=config.model.num_layers_unfrozen,
            compute_dtype=DTYPES[config.model.compute_dtype],
            remat=config.train.remat,
            attention_fn=self._train_attention_fn(),
            tp=tp,
            sp=self.sp,
            # every forward the policy runs: train batches, rollout
            # scoring chunks (eval decodes, it does not score)
            **self._pp_kwargs(spec.n_layer - k, config.train.batch_size,
                              config.method.chunk_size),
        )
        frozen_dtype = DTYPES[config.model.param_dtype]
        #: the model state's bytes as the memory pre-check estimates them
        self.state_bytes = self._check_memory_fit(spec, frozen_dtype)
        if params is None and trunk is not None:
            params = hydra_params_from_trunk(
                self.policy, *trunk, np.random.default_rng(config.train.seed),
                frozen_dtype=frozen_dtype)
        elif params is None:
            params = init_hydra_numpy(spec, config.model.num_layers_unfrozen,
                                      seed=config.train.seed)
        self.opt = build_optimizer(config.train)
        self.params, self.opt_state = self._shard_model_state(
            hydra_to_torch(params, self.device, frozen_dtype))
        del params, trunk

        self.store = PPORolloutStorage()
        m = config.method
        self.kl_ctl = make_kl_controller(m.init_kl_coef, m.target, m.horizon)
        eos = getattr(self.tokenizer, "eos_token_id", -1)
        self.gen_config = GenerationConfig.from_gen_kwargs(
            config.train.gen_size, m.gen_kwargs or {},
            eos_token_id=eos if eos is not None else -1,
            pad_token_id=getattr(self.tokenizer, "pad_token_id", 0) or 0,
            prompt_len=config.train.input_size,
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.train.seed)
        self.orch = None
        self.reward_fn: Optional[Callable] = None
        # analytic throughput accounting: one optimization step touches
        # input + gen tokens
        self._tokens_per_sample = (config.train.input_size
                                   + config.train.gen_size)
        self._flops_per_token = telemetry.ppo_train_flops_per_token(
            spec, config.model.num_layers_unfrozen)
        # resume at construction: rollouts made before learn() must come
        # from the restored policy
        self.maybe_resume()

    def set_orchestrator(self, orch, reward_fn: Callable) -> None:
        self.orch = orch
        self.reward_fn = reward_fn

    # -- rollout ---------------------------------------------------------- #

    def generate(self, query_tokens, query_mask, phase_args=None):
        """Decode ``gen_size`` tokens for a prompt batch; on a mesh each
        process decodes its rows (a batch that dp * fsdp does not divide
        is padded with its last row, and the outputs sliced back).
        ``phase_args``: a rollout chunk's, for generate's phases."""
        (query, mask), n = self._pad_rows((query_tokens, query_mask))
        query, mask = self._put((query, mask))
        params = self._whole_params()
        embed, ln_f = head_params_for_decode(params)
        out = generate(
            self.policy.spec, all_blocks(params), embed, ln_f, query,
            mask, self.generator, self.gen_config,
            compute_dtype=self.policy.compute_dtype, decoder=self.decoder,
            mesh=self.mesh, phase_args=phase_args,
        )
        if out.sequences.shape[0] != n:
            out = type(out)(*(x[:n] for x in out))
        return out

    @torch.no_grad()
    def score(self, sequences, attention_mask, response_mask, kl_coef,
              input_size: int):
        """One shared-trunk forward -> (logprobs, values, KL-penalty
        rewards without the task score, per-sequence KL) over the
        response window, logprobs chunked through each branch's head so
        the [B, T, V] logits are never materialized. On a mesh each
        process scores its rows and the results come back whole."""
        policy, mesh = self.policy, self.mesh
        params = self._forward_params()
        sequences, attention_mask, response_mask = (
            rows_of(x, mesh) for x in (sequences, attention_mask,
                                       response_mask))
        h_top, h_ref, values = policy.forward_hidden(
            params, sequences, attention_mask, with_ref=True)
        P = input_size
        embed = params["frozen_base"]["embed"]
        logprobs = self._response_logprobs(
            policy.branch_head_fn(params["trainable"], embed), h_top,
            sequences, P, chunked=True)
        ref_logprobs = self._response_logprobs(
            policy.branch_head_fn(params["ref"], embed), h_ref, sequences,
            P, chunked=True)
        values = self._response_values(values, P, sequences.shape[1])
        rewards, seq_kl = kl_penalty_rewards(
            logprobs, ref_logprobs,
            torch.zeros(sequences.shape[0], device=sequences.device),
            kl_coef, mask=response_mask)
        return tuple(gather_rows(x, mesh) for x in
                     (logprobs, values, rewards, seq_kl))

    def _response_logprobs(self, head_fn, h, tokens, P: int,
                           chunked: bool = False) -> torch.Tensor:
        """Logprobs [B, G] of the response tokens ``tokens[:, P:]`` from
        the layernormed hidden states ``h`` of positions P - 1 .. T - 2
        (``head_fn``: hidden -> float32 logits; ``chunked`` through
        ``chunked_label_logprobs``, so no [B, T, V] logits are held).
        Under sp ``h`` is this process's chunk of positions: it projects
        only its part of the window and the per-token logprobs are
        gathered over sp (a process with none of the window, its chunk
        ending before the window starts or starting after it ends,
        projects an empty slice, so every head parameter stays in the
        graph)."""
        T = tokens.shape[1]

        def logprobs(x, labels):
            if chunked and x.shape[1]:
                return chunked_label_logprobs(head_fn, x, labels)
            return logprobs_from_logits(head_fn(x), labels)

        if self.sp is None:
            return logprobs(h[:, P - 1:T - 1], tokens[:, P:])
        start, stop = self.sp.bounds(T)
        lo = min(max(start, P - 1), stop)
        hi = max(lo, min(stop, T - 1))
        part = logprobs(h[:, lo - start:hi - start], tokens[:, lo + 1:hi + 1])
        zeros = part.new_zeros
        local = torch.cat([zeros((part.shape[0], lo - start)), part,
                           zeros((part.shape[0], stop - hi))], dim=1)
        return self.sp.gather(local)[:, P - 1:T - 1]

    def _response_values(self, values, P: int, T: int) -> torch.Tensor:
        """Values [B, G] at positions P - 1 .. T - 2, gathered over sp
        when ``values`` is this process's chunk."""
        if self.sp is not None:
            values = self.sp.gather(values)
        return values[:, P - 1:T - 1]

    def rollout(self, bank_tokens, bank_mask, idx, chunk: int = 0):
        """Rollout chunk ``chunk``: prompts ``idx`` of the bank ->
        generation -> scoring, as the telemetry phases
        ``rollout/prefill``, ``rollout/decode`` and ``rollout/score``
        (each with the chunk's index and row count). Returns (out, query,
        query_mask, logprobs, values, kl_rewards, seq_kl) on the
        device."""
        idx = torch.as_tensor(np.asarray(idx), device=bank_tokens.device)
        query, query_mask = bank_tokens[idx], bank_mask[idx]
        args = {"chunk": chunk, "rows": int(idx.shape[0])}
        out = self.generate(query, query_mask, phase_args=args)
        with telemetry.device_phase("rollout/score", **args):
            logprobs, values, kl_rewards, seq_kl = self.score(
                out.sequences, out.attention_mask, out.gen_mask,
                float(self.kl_ctl.value), query.shape[1])
        return out, query, query_mask, logprobs, values, kl_rewards, seq_kl

    def finalize_rewards(self, kl_rewards, gen_mask, scores):
        """kl_rewards + the task score on each row's last real token."""
        rows = torch.arange(kl_rewards.shape[0], device=kl_rewards.device)
        last = (gen_mask.sum(dim=-1).long() - 1).clamp(min=0)
        if not torch.is_tensor(scores):
            scores = torch.as_tensor(np.asarray(scores, np.float32))
        scores = scores.to(device=kl_rewards.device, dtype=torch.float32)
        return kl_rewards.index_put((rows, last), scores, accumulate=True)

    def act(self, batch):
        """Generate for a prompt batch: (query, response tokens, texts)."""
        query, mask = batch
        out = self.generate(query, mask)
        texts = self.tokenizer.batch_decode(out.sequences.cpu().numpy(),
                                            skip_special_tokens=True)
        return np.asarray(query), out.gen_tokens.cpu().numpy(), texts

    def sample(self, prompts, length: int, n_samples: int):
        enc = self.tokenizer(prompts, max_length=self.config.train.input_size,
                             padding="max_length", truncation=True)
        out = self.generate(np.asarray(enc["input_ids"]),
                            np.asarray(enc["attention_mask"]))
        return self.tokenizer.batch_decode(out.sequences.cpu().numpy())

    # -- update ----------------------------------------------------------- #

    def train_step(self, batch: PPORLBatch) -> Dict[str, torch.Tensor]:
        """One PPO update on ``batch`` (on the trainer's device): GAE and
        whitened advantages, the policy forward over query + response
        (attending what generation attended: the rollout's prompt mask,
        response pads included; only the losses exclude pads), the
        clipped losses, the optimizer step (through the commit gate when
        ``max_bad_steps > 0``). Returns the stats, with the pre-clip
        ``grad_norm`` and, with the gate, ``bad_step``.

        On a mesh (``batch`` from ``_put``: rows sharded over (dp,
        fsdp)) the forward runs this process's rows with the parameters
        gathered on use, and GAE, the whitening and the losses run on
        the whole batch: the single-process step, with the gradients
        summed across the processes' rows (and, under sp, their chunks
        of positions)."""
        m, mesh = self.config.method, self.mesh
        rows = batch
        if mesh is not None:
            batch = self._put(batch)  # no-op for a batch already sharded
            rows, batch = batch.map(local_rows), batch.map(whole)
        query, response = batch.query_tensors, batch.response_tensors
        P, G = query.shape[1], response.shape[1]
        old_values, resp_mask = batch.values, batch.response_masks
        with torch.no_grad():
            advantages, returns = gae_advantages(
                old_values, batch.rewards, m.gamma, m.lam, mask=resp_mask)
            advantages = whiten(advantages, mask=resp_mask)
        tokens = torch.cat([rows.query_tensors, rows.response_tensors], dim=1)
        mask = torch.cat([rows.query_masks,
                          torch.ones_like(rows.response_tensors,
                                          dtype=torch.int32)], dim=1)
        params = self._forward_params()
        h_top, _, values = self.policy.forward_hidden(params, tokens, mask,
                                                      with_ref=False)
        head = self.policy.branch_head_fn(
            params["trainable"], params["frozen_base"]["embed"])
        logprobs = self._response_logprobs(head, h_top, tokens, P)
        values = self._response_values(values, P, P + G)
        loss, stats = ppo_losses(
            gather_rows(logprobs, mesh), gather_rows(values, mesh),
            batch.logprobs, old_values, advantages, returns, m.cliprange,
            m.cliprange_value, m.vf_coef, mask=resp_mask)
        leaves = _leaves(self.params["trainable"])
        grads = torch.autograd.grad(loss, leaves)
        self._apply_update(loss, leaves, grads, stats,
                           kl_limit=getattr(self.config.train, "max_step_kl",
                                            0.0))
        return {k: v.detach() for k, v in stats.items()}

    def train_multi(self, batch: PPORLBatch) -> Dict[str, torch.Tensor]:
        """``ppo_epochs`` passes over one minibatch; the last pass's
        stats, with ``bad_step`` the max over the passes (each pass gates
        itself; the host counts the batch once). On a mesh the batch goes
        through ``shard_batch`` once."""
        if self.mesh is not None:
            batch = self._put(batch)
        bad = None
        for _ in range(self.config.method.ppo_epochs):
            stats = self.train_step(batch)
            if "bad_step" in stats:
                bad = stats["bad_step"] if bad is None \
                    else torch.maximum(bad, stats["bad_step"])
        if bad is not None:
            stats["bad_step"] = bad
        return stats

    # -- loop ------------------------------------------------------------- #

    def evaluate(self, eval_prompts=None, n: int = 16):
        """Generate from eval prompts (by default a rotating shuffled batch
        of the pipeline's) and score them with ``reward_fn``."""
        if self.reward_fn is None:
            return {}
        if eval_prompts is None:
            if self.orch is None:
                return {}
            self._eval_round = getattr(self, "_eval_round", -1) + 1
            loader = self.orch.pipeline.create_loader(
                n, shuffle=True, seed=self._eval_round)
            try:
                eval_prompts = next(iter(loader))
            except StopIteration:
                return {}
        query, mask = eval_prompts
        t = self.config.train
        # a telemetry span and a supervisor phase: a hung eval or reward
        # call is a stalled phase; the phase closes after the tokens and
        # the scores are on the host
        with annotate("eval"):
            chaos.maybe_inject("eval")
            out = self.generate(query, mask)
            texts = self.tokenizer.batch_decode(out.sequences.cpu().numpy(),
                                                skip_special_tokens=True)
            with annotate("reward_fn"):
                scores = np.asarray(retry_call(
                    self.reward_fn, texts, retries=t.host_retries,
                    backoff=t.host_retry_backoff, timeout=seam_timeout(t),
                    seam="reward_fn", label="reward_fn (eval)"), np.float32)
        decode = self.tokenizer.batch_decode
        return {
            "mean_score": float(scores.mean()),
            "samples": texts[:4],
            "generations_table": generations_table(
                decode(np.asarray(query), skip_special_tokens=True),
                decode(out.gen_tokens.cpu().numpy(),
                       skip_special_tokens=True),
                scores),
        }

    def learn(self, log_fn: Callable = None, save_fn=None, eval_fn=None):
        """The PPO loop: minibatches over the rollout store (shuffled with
        the epoch as seed), ``ppo_epochs`` passes per batch in a
        ``ppo_update`` phase, logging / eval / checkpoints between
        batches, fresh experience after each epoch (``rollout_refresh``).
        Stops when EITHER ``total_steps`` or ``epochs`` is reached, as
        trlx_tpu does, or at the first boundary after a SIGTERM or past
        ``train.max_walltime`` (saving first). Resumes from
        ``train.resume_from`` once per process; with ``max_bad_steps >
        0`` the StepGuard rolls back to the latest checkpoint or aborts
        (DivergenceError).

        The run floor: stats go to ``log_fn``, or to ``train.tracker``
        when none is given; each emission carries the telemetry payload
        (``time/*`` last durations, ``throughput/*``, ``fault/*``,
        ``device/*``, ``compile/*``); ``telemetry.json`` and
        ``trace.jsonl`` land in the run dir at every exit. The run
        supervisor watches the phases (``train.stall_timeout``), and a
        hung host seam past its retry budget becomes a checkpoint and a
        re-raised StallError. ``$TRLX_TPU_PROFILE_DIR`` wraps the loop
        in torch.profiler."""
        log_fn = self._make_tracker(log_fn)
        clock = Clock()
        self.maybe_resume()  # no-op when already restored at construction
        step_guard = self._make_step_guard(log_fn)
        sup = self._make_supervisor()
        try:
            with maybe_trace(), self._preemption_guard() as guard, sup:
                self._learn_loop(log_fn, guard, step_guard, clock, sup)
        except StallError:
            self._contain_stall(log_fn)
            raise
        finally:
            # every exit path leaves telemetry.json + trace.jsonl
            self._finish_telemetry("ppo", clock)

    @staticmethod
    def _epoch_batch_count(n_rows: int, batch_size: int) -> int:
        """Batches one epoch runs over ``n_rows`` store rows (the loader
        drops the last partial batch): the one definition that
        :meth:`_will_refresh` predicts the epoch's end from."""
        return n_rows // batch_size

    def _will_refresh(self, cfg, m) -> bool:
        """Whether the post-epoch refresh will run, predicted before the
        epoch's updates: the epoch advances ``iter_count`` by exactly
        ``_epoch_batch_count * ppo_epochs``, which lets continuous mode
        dispatch the next epoch's rollouts before this epoch's updates."""
        if self.orch is None:
            return False
        n_batches = self._epoch_batch_count(len(self.store), cfg.batch_size)
        end_count = self.iter_count + n_batches * m.ppo_epochs
        return end_count < cfg.total_steps and self.epoch + 1 < cfg.epochs

    def _learn_loop(self, log_fn, guard, step_guard, clock, sup) -> None:
        cfg, m = self.config.train, self.config.method
        while self.iter_count < cfg.total_steps and self.epoch < cfg.epochs:
            loader = self.store.create_loader(cfg.batch_size, shuffle=True,
                                              seed=self.epoch)
            pending = None
            if cfg.continuous_rollouts and self._will_refresh(cfg, m):
                # the NEXT epoch's rollouts, enqueued now against the
                # pre-update params: the card runs them ahead of the
                # updates queued below (one update phase stale)
                with annotate("rollout_dispatch_stale"):
                    pending = self.orch.start_experience(m.num_rollouts,
                                                         self.iter_count)
            for batch in loader:
                # the phase closes after a device sync, so its time (and
                # a hung kernel) belongs to the update
                with annotate("ppo_update"):
                    chaos.maybe_inject("ppo_update")
                    stats = self.train_multi(batch)
                    self.iter_count += m.ppo_epochs
                    self._sync()
                clock.tick(len(batch) * m.ppo_epochs)
                # a rollback restores params, optimizer and iter_count
                # from the latest checkpoint, and the loop goes on
                self._observe_step(step_guard, stats)
                intervals = self.intervals(self.iter_count)
                if intervals["do_log"]:
                    host_stats = {k: float(v) for k, v in stats.items()}
                    sps = clock.samples_per_second()
                    host_stats.update(
                        iter=self.iter_count, epoch=self.epoch,
                        kl_coef=float(self.kl_ctl.value),
                        samples_per_sec=sps,
                    )
                    host_stats.update(self._telemetry_stats(sps))
                    log_fn(host_stats)
                if intervals["do_eval"]:
                    ev = self.evaluate()
                    if ev:
                        log_fn({"iter": self.iter_count, **ev})
                if intervals["do_save"]:
                    self.save()
                self._maybe_flush_telemetry()
                if self._preempt(log_fn, guard,
                                 just_saved=intervals["do_save"], sup=sup):
                    return
                if self.iter_count >= cfg.total_steps:
                    break
            self.epoch += 1
            if pending is not None or (
                    self.orch is not None and self.iter_count < cfg.total_steps
                    and self.epoch < cfg.epochs):
                self.store.clear_history()
                if pending is not None:
                    # continuous mode: harvest what was dispatched before
                    # this epoch's updates (a preemption above abandons it)
                    with annotate("rollout_harvest"):
                        info = self.orch.finish_experience(pending)
                else:
                    with annotate("rollout_refresh"):
                        info = self.orch.make_experience(m.num_rollouts,
                                                         self.iter_count)
                log_fn({"iter": self.iter_count, "epoch": self.epoch, **info,
                        **self._telemetry_stats(clock.samples_per_second())})
                if self._preempt(log_fn, guard, sup=sup):
                    return

    def post_rollout_kl_update(self, mean_kl: float, n_samples: int) -> None:
        self.kl_ctl.update(mean_kl, n_samples)

    def get_components(self) -> Dict:
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "state": {"iter_count": self.iter_count, "epoch": self.epoch,
                      "kl_coef": self.kl_ctl.value,
                      "generator": self._generator_state()},
            # self-describing: the serve CLI rebuilds the policy from it
            "config": self.config.to_nested_dict(),
        }

    def set_components(self, components: Dict) -> None:
        super().set_components(components)
        state = components["state"]
        self.iter_count = int(state["iter_count"])
        self.epoch = int(state["epoch"])
        self.kl_ctl.value = float(state["kl_coef"])
        self._set_generator_state(state["generator"])
