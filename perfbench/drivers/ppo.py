"""PPO with a reward model on the card: ``PPOOrchestrator.make_experience``
(graphed decode, scoring, the reward model) and the trainer's update
passes (``ppo_epochs`` passes over each minibatch of the store), one
cycle after another, as the trainer's own loop runs them.

Set-up builds the trainer from a seeded checkpoint in HF's layout (the
port's converter), the reward model from its trunk
(``examples/ppo_tldr.build_reward_model``) and the prompt bank, then
runs one whole cycle; that cycle's rollout and its first three updates
are recorded and later held against the plain reference. The window
runs whole cycles; ``ppo_samples_per_s`` is the samples of the cycles
that finished within ``--seconds`` over the time from the window's
start to the end of the last of them, stalls included.
"""

import json
import time

import numpy as np
import torch

from perfbench import traffic, weights, yardstick
from perfbench.probe import FlashCalls, TrainProbe, port_spec
from perfbench.reference import gpt
from perfbench.reference import ppo as ref_ppo
from perfbench.reference.leaves import leaf_norms
from perfbench.reference.optim import (
    leaf_gaps,
    loss_gap,
    small_gradient_leaves,
)


class PPO:
    def __init__(self, ctx):
        self.ctx = ctx
        self.bad = 0

    def config(self):
        from trlx_tpu_torch.data.configs import TRLConfig
        from trlx_tpu_torch.examples import ppo_tldr

        cfg = ppo_tldr.tldr_config()
        for section, values in self.ctx.cell["trainer"].items():
            cfg[section].update(values)
        cfg["model"]["model_spec"] = dict(self.ctx.spec)
        cfg["train"]["seed"] = self.ctx.seed
        self.cfg_dict = json.loads(json.dumps(cfg))
        return TRLConfig.from_dict(cfg)

    def prompts(self, pad_id: int):
        """Left-padded prompt bank [N, input_size]: documents of the
        traffic's lengths, each ending in the TL;DR cue."""
        ctx, t = self.ctx, self.ctx.traffic
        n, P = ctx.cell["prompts"], self.cfg_dict["train"]["input_size"]
        cue = np.asarray(t["cue_tokens"], np.int32)
        lengths = traffic.sizes(t["lengths"], n,
                                traffic.rng_for(ctx.seed, "lengths"))
        bodies = traffic.token_rows(lengths - len(cue),
                                    ctx.spec["vocab_size"],
                                    traffic.rng_for(ctx.seed, "tokens"))
        ids = np.full((n, P), pad_id, np.int32)
        mask = np.zeros((n, P), np.int32)
        for i, body in enumerate(bodies):
            row = np.concatenate([body, cue])
            ids[i, P - len(row):] = row
            mask[i, P - len(row):] = 1
        return ids, mask

    def setup(self):
        from trlx_tpu_torch.examples import ppo_tldr
        from trlx_tpu_torch.models.hf_import import (
            convert_state_dict,
            hydra_params_from_trunk,
        )
        from trlx_tpu_torch.models.policy import HydraPolicy
        from trlx_tpu_torch.utils import DTYPES
        from trlx_tpu_torch.utils.loading import (
            get_model,
            get_orchestrator,
            get_pipeline,
        )

        ctx = self.ctx
        cfg = self.config()
        spec = port_spec(ctx.spec)
        frozen = DTYPES[cfg.model.param_dtype]
        sd = weights.state_dict(ctx.spec, ctx.seed, ctx.device, frozen)
        trunk = convert_state_dict(sd, spec, dtype=None)
        del sd
        tree = hydra_params_from_trunk(
            HydraPolicy(spec, cfg.model.num_layers_unfrozen), *trunk,
            np.random.default_rng(ctx.seed), frozen_dtype=frozen)
        del trunk
        self.trainer = trainer = get_model(cfg.model.model_type)(
            cfg, device=ctx.device, params=tree)
        del tree
        self.head_seed = ctx.seed + 1
        rm = ppo_tldr.build_reward_model(cfg, trainer,
                                         head_seed=self.head_seed)
        self.eos = int(trainer.tokenizer.eos_token_id)
        ids, mask = self.prompts(int(trainer.tokenizer.pad_token_id))
        pipeline = get_pipeline(cfg.train.pipeline)(
            ["."] * len(ids), trainer.tokenizer, cfg)
        pipeline.tokens, pipeline.masks = ids, mask
        self.orch = get_orchestrator(cfg.train.orchestrator)(
            trainer, pipeline, reward_fn=rm,
            chunk_size=cfg.method.chunk_size)
        self.probe = TrainProbe(trainer, steps=3)
        self.cycle(record=True)
        ctx.sync()

    def cycle(self, record: bool = False) -> int:
        """One cycle: fresh experience, then every update pass over it;
        returns the samples it trained on."""
        trainer, m = self.trainer, self.trainer.config.method
        bs = trainer.config.train.batch_size
        trainer.store.clear_history()
        with self.ctx.span("ppo.rollout", sync=True):
            self.orch.make_experience(m.num_rollouts, trainer.iter_count)
        if record:
            data = trainer.store._stacked()
            self.rollout = {k: getattr(data, k).detach().cpu().numpy()
                            for k in ("query_tensors", "query_masks",
                                      "response_tensors", "logprobs",
                                      "values", "rewards", "response_masks")}
        samples = len(trainer.store)
        with self.ctx.span("ppo.update", sync=True):
            for batch in trainer.store.create_loader(bs, shuffle=True,
                                                     seed=trainer.epoch):
                stats = trainer.train_multi(batch)
                trainer.iter_count += m.ppo_epochs
                if not np.isfinite(float(stats["loss"])):
                    self.bad += len(batch)
            trainer.epoch += 1
        return samples

    # -- window --------------------------------------------------------- #

    def window(self):
        ctx = self.ctx
        flash = FlashCalls()
        self.bad, samples, n, last = 0, 0, 0, 0.0
        traced = None
        done = {"rollout_samples": 0, "update_samples": 0}
        t0 = end = time.perf_counter()
        while True:
            now = time.perf_counter()
            if n and now - t0 + last > ctx.seconds:
                break
            if ctx.tracer.on and traced is None and n == ctx.cell[
                    "trace_cycle"]:
                with ctx.tracer.capture(), flash.recording():
                    got = self.cycle()
                traced = self.cycle_flops()
            else:
                got = self.cycle()
            done["rollout_samples"] += got
            done["update_samples"] += got
            t = time.perf_counter()
            if t - t0 > ctx.seconds:
                break
            samples, n, end, last = samples + got, n + 1, t, t - now
        readings = dict(done, flash_calls=flash.calls, traced_flops=traced)
        return {"metrics": {"ppo_samples_per_s": samples / max(end - t0,
                                                               1e-9)},
                "attempted": done["rollout_samples"], "failed": self.bad,
                "readings": readings}

    def cycle_flops(self) -> int:
        """Model FLOPs the cycle now in the store needed: the rollout's
        prefill and decode of each row's real tokens, one forward of the
        policy trunk, the reference branch and the reward model per
        sample, and per pass the trainable branch's forward and backward
        over the sample (the frozen trunk's forward in each pass is
        recomputed work and is not counted). The trainable branch and the
        reference branch are the top ``k`` layers by index."""
        spec, trainer = self.ctx.spec, self.trainer
        data = trainer.store._stacked()
        prompt = data.query_masks.sum(1).tolist()
        gen = data.response_masks.sum(1).tolist()
        L = spec["n_layer"]
        every, top = range(L), range(L - trainer.policy.k, L)
        d = spec["d_model"]
        lm, vh = yardstick.lm_head_flops(spec), yardstick.head_flops(d, 1)
        epochs = trainer.config.method.ppo_epochs
        total = 0
        for p, g in zip(prompt, gen):
            p, g = int(p), int(g)
            total += yardstick.prefill_flops(spec, every, p)
            total += yardstick.decode_flops(spec, every, p, max(g - 1, 0))
            n = p + g
            total += yardstick.forward_flops(spec, every, [n]) \
                + yardstick.forward_flops(spec, top, [n]) + g * (2 * lm + vh)
            total += yardstick.forward_flops(spec, every, [n]) + vh
            total += epochs * 3 * (yardstick.forward_flops(spec, top, [n])
                                   + g * (lm + vh))
        return total

    # -- check ---------------------------------------------------------- #

    def release(self):
        probe = self.probe
        first = probe.batches[0]
        rows = ref_ppo.rows_of(
            np.concatenate([self.rollout["query_tensors"],
                            self.rollout["response_tensors"]], 1),
            np.concatenate([first.query_tensors.cpu().numpy(),
                            first.response_tensors.cpu().numpy()], 1))
        self.recorded = {"losses": probe.losses, "grad": probe.grad,
                         "change": probe.change, "rows": rows,
                         "rollout": self.rollout}
        self.trainer = self.orch = self.probe = None

    def reference(self, prec: gpt.Precision, drop_half: bool = False):
        ctx, r = self.ctx, self.recorded
        spec, dev = ctx.spec, ctx.device
        from trlx_tpu_torch.utils import DTYPES

        sd = weights.state_dict(spec, ctx.seed, dev,
                                DTYPES[self.cfg_dict["model"]["param_dtype"]])
        d = spec["d_model"]
        v_head = gpt.init_head(np.random.default_rng(ctx.seed), d, 1, dev)
        r_head = gpt.init_head(np.random.default_rng(self.head_seed), d, 1,
                               dev)
        ro = r["rollout"]

        def t(x):
            return torch.as_tensor(x, device=dev)

        k = self.cfg_dict["model"]["num_layers_unfrozen"]
        out = ref_ppo.rollout(sd, spec, t(ro["query_tensors"]).long(),
                              t(ro["query_masks"]).long(),
                              t(ro["response_tensors"]).long(), v_head,
                              r_head, self.eos, k, prec,
                              ctx.cell["reference_rows"])
        rows = r["rows"][:len(r["rows"]) // 2] if drop_half else r["rows"]
        idx = t(np.asarray(rows))
        batch = {"query": t(ro["query_tensors"]).long()[idx],
                 "qmask": t(ro["query_masks"]).long()[idx],
                 "response": t(ro["response_tensors"]).long()[idx],
                 "h_split": out["h_split"][idx],
                 **{key: out[key][idx] for key in
                    ("logprobs", "values", "rewards", "gen_mask")}}
        del out["h_split"]
        top = ref_ppo.top_prefixes(spec, k)
        sd = {n: w for n, w in sd.items() if n.startswith(top)}
        up = ref_ppo.updates(sd, spec, v_head, batch, self.cfg_dict["method"],
                             self.cfg_dict["train"], k, 3, prec,
                             self.ctx.cell["reference_rows"])
        return {"rollout": {key: out[key].cpu().numpy() for key in
                            ("logprobs", "values", "rewards", "gen_mask",
                             "scores")},
                "losses": up["losses"],
                "grad": leaf_norms(up["grad_tensors"], spec),
                "change": leaf_norms(up["change"], spec)}

    def half_fault(self):
        """The reference with half of the minibatch left out (a fault)."""
        return self.reference(gpt.Precision("float32"), drop_half=True)

    @staticmethod
    def gaps(ours, ref):
        a, b = ours["rollout"], ref["rollout"]
        gm = b["gen_mask"].astype(bool)
        mine = a["response_masks"] if "response_masks" in a else a["gen_mask"]
        scale_v = float(np.sqrt(np.mean(b["values"][gm] ** 2)))
        scale_r = float(np.sqrt(np.mean(b["scores"] ** 2)))
        skip = small_gradient_leaves(ref["grad"])
        return {
            "mask_gap": float(np.mean(mine.astype(bool) != gm)),
            "logprob_gap": float(np.max(np.abs(a["logprobs"] - b["logprobs"])
                                        [gm])),
            "value_gap": float(np.max(np.abs(a["values"] - b["values"])[gm]))
            / scale_v,
            "reward_gap": float(np.max(np.abs(a["rewards"] - b["rewards"])
                                       [gm])) / scale_r,
            "loss_gap": loss_gap(ours["losses"], ref["losses"]),
            "grad_gap": max(leaf_gaps(ours["grad"], ref["grad"]).values()),
            "change_gap": max(leaf_gaps(ours["change"], ref["change"],
                                        skip).values()),
        }

    def check(self):
        gaps = self.gaps(self.recorded, self.reference(
            gpt.Precision("float32")))
        limits = self.ctx.cell["limits"]
        return [(k, gaps[k], limits[k]) for k in limits]


def make(ctx):
    return PPO(ctx)
