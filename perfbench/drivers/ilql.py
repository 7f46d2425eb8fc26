"""Offline ILQL: the trainer's update step over a dataset of scored
rows, fed as its own loop feeds it (the collated dataset on the device,
a shuffled pass per epoch, the target Q heads synced every
``steps_for_target_q_sync`` updates).

Set-up builds the trainer from a seeded checkpoint and runs its first
``warm_updates`` updates; the first three are recorded and later held
against the plain reference. The window then runs whole updates;
``ilql_tokens_per_s`` is the real tokens of the updates that finished
within ``--seconds`` over the time from the window's start to the end of
the last of them.
"""

import json
import time

import numpy as np
import torch

from perfbench import traffic, weights, yardstick
from perfbench.probe import FlashCalls, TrainProbe, port_spec
from perfbench.reference import gpt
from perfbench.reference import ilql as ref_ilql
from perfbench.reference.leaves import leaf_norms
from perfbench.reference.optim import (
    leaf_gaps,
    loss_gap,
    small_gradient_leaves,
)


class ILQL:
    def __init__(self, ctx):
        self.ctx = ctx
        self.trainer = None
        self.bad = 0
        self.batch_rows = []

    # -- inputs ------------------------------------------------------- #

    def make_rows(self):
        ctx, t = self.ctx, self.ctx.traffic
        n = ctx.cell["rows"]
        lengths = traffic.sizes(t["lengths"], n,
                                traffic.rng_for(ctx.seed, "lengths"))
        rows = traffic.token_rows(lengths, ctx.spec["vocab_size"],
                                  traffic.rng_for(ctx.seed, "tokens"))
        scores = traffic.rng_for(ctx.seed, "rewards").standard_normal(n)
        return rows, scores.astype(np.float32)

    def config(self):
        from trlx_tpu_torch.data.configs import TRLConfig
        from trlx_tpu_torch.examples import ilql_sentiments

        cfg = ilql_sentiments.ilql_config()
        for section, values in self.ctx.cell["trainer"].items():
            cfg[section].update(values)
        cfg["model"]["model_spec"] = dict(self.ctx.spec)
        cfg["train"]["seed"] = self.ctx.seed
        self.cfg_dict = json.loads(json.dumps(cfg))
        return TRLConfig.from_dict(cfg)

    # -- set-up --------------------------------------------------------- #

    def setup(self):
        from trlx_tpu_torch.models.hf_import import (
            convert_state_dict,
            ilql_params_from_trunk,
        )
        from trlx_tpu_torch.models.ilql import ILQLModel
        from trlx_tpu_torch.utils.loading import get_model, get_orchestrator

        ctx = self.ctx
        cfg = self.config()
        spec = port_spec(ctx.spec)
        sd = weights.state_dict(ctx.spec, ctx.seed, ctx.device,
                                torch.float32)
        trunk = convert_state_dict(sd, spec, dtype=None)
        del sd
        net = ILQLModel(spec=spec,
                        num_layers_unfrozen=cfg.model.num_layers_unfrozen,
                        two_qs=cfg.method.two_qs)
        tree = ilql_params_from_trunk(net, *trunk,
                                      np.random.default_rng(ctx.seed))
        del trunk
        self.trainer = trainer = get_model(cfg.model.model_type)(
            cfg, device=ctx.device, params=tree)
        del tree
        self.rows, self.scores = self.make_rows()
        scores = self.scores
        get_orchestrator(cfg.train.orchestrator)(
            trainer, [r.tolist() for r in self.rows],
            [trainer.tokenizer.eos_token] * 8,
            reward_fn=lambda samples: scores)
        full, resident = trainer._collate_store()
        self.width = int(full.input_ids.shape[1])
        self.pad_id = min(trainer.tokenizer.eos_token_id,
                          spec.vocab_size - 1)
        self.dataset = full.map(lambda x: torch.as_tensor(x).to(ctx.device))
        self.lengths = np.array([len(r) for r in self.rows])
        self.epoch, self.order = -1, []
        self.probe = TrainProbe(trainer, steps=3)
        for _ in range(ctx.cell["warm_updates"]):
            self.update()
        ctx.sync()

    def next_rows(self):
        from trlx_tpu_torch.pipeline import batch_iterator

        if not self.order:
            self.epoch += 1
            n, bs = len(self.rows), self.trainer.config.train.batch_size
            self.order = list(batch_iterator(n, bs, True, self.epoch,
                                             lambda idx: idx))
        return self.order.pop(0)

    def update(self):
        """One update on the next batch; returns its real tokens."""
        trainer = self.trainer
        idx = self.next_rows()
        rows = torch.as_tensor(idx, device=self.ctx.device)
        batch = self.dataset.map(lambda x: x[rows])
        with self.ctx.span("ilql.update", sync=True):
            stats = trainer.train_step(batch)
            trainer.iter_count += 1
            m = trainer.config.method
            if trainer.iter_count % m.steps_for_target_q_sync == 0:
                trainer.sync_targets()
        self.bad += not np.isfinite(float(stats["loss"]))
        self.batch_rows.append(idx)
        return int(self.lengths[idx].sum())

    # -- window --------------------------------------------------------- #

    def window(self):
        ctx, trainer = self.ctx, self.trainer
        cuda = ctx.device == "cuda"
        if cuda:
            trainer.step_events = []
        flash = FlashCalls()
        self.bad = 0
        start, count = ctx.cell["trace_updates"]
        traced_rows, tokens, n, last, ran = None, 0, 0, 0.0, 0
        t0 = end = time.perf_counter()
        while True:
            now = time.perf_counter()
            if n and now - t0 + last > ctx.seconds:
                break
            if ctx.tracer.on and traced_rows is None and n == start:
                with ctx.tracer.capture(), flash.recording():
                    got = sum(self.update() for _ in range(count))
                traced_rows = self.batch_rows[-count:]
                steps = count
            else:
                got, steps = self.update(), 1
            t = time.perf_counter()
            ran += steps
            if t - t0 > ctx.seconds:
                break
            tokens, n, end = tokens + got, n + steps, t
            last = (t - now) / steps
        parts = []
        if cuda:
            parts = [[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                     for ev in trainer.step_events]
            trainer.step_events = None
        readings = {"step_parts_ms": parts, "flash_calls": flash.calls,
                    "traced_flops": None if traced_rows is None else sum(
                        self.update_flops(i) for i in traced_rows)}
        return {"metrics": {"ilql_tokens_per_s": tokens / max(end - t0,
                                                              1e-9)},
                "attempted": ran, "failed": self.bad, "readings": readings}

    def update_flops(self, idx) -> int:
        """Model FLOPs one update needs over its real tokens: forward and
        backward (3x the forward) of the whole model and the trainable
        heads (LM head tied, V head, two Q heads), the two target Q
        heads' forward."""
        spec = self.ctx.spec
        d, V = spec["d_model"], spec["vocab_size"]
        lengths = [int(x) for x in self.lengths[idx]]
        heads = yardstick.lm_head_flops(spec) + 2 * yardstick.head_flops(
            d, V) + yardstick.head_flops(d, 1)
        fwd = yardstick.forward_flops(spec, range(spec["n_layer"]),
                                      lengths) + sum(lengths) * heads
        return 3 * fwd + sum(lengths) * 2 * yardstick.head_flops(d, V)

    # -- check ---------------------------------------------------------- #

    def release(self):
        probe = self.probe
        first = [probe.batches[i].input_ids.cpu().numpy() for i in range(3)]
        self.recorded = {"losses": probe.losses, "grad": probe.grad,
                         "change": probe.change, "rows": [
                             self.batch_rows[i] for i in range(3)]}
        for i, ids in enumerate(first):  # the feed gave the rows it named
            for b, r in enumerate(self.recorded["rows"][i]):
                if not np.array_equal(ids[b, :len(self.rows[r])],
                                      self.rows[r]):
                    raise RuntimeError(f"update {i} row {b} is not row {r}")
        self.trainer = self.dataset = self.probe = None

    def reference(self, prec: gpt.Precision, drop_half: bool = False):
        """The reference's first three updates on the recorded rows."""
        ctx, cell = self.ctx, self.ctx.cell
        sd = weights.state_dict(ctx.spec, ctx.seed, ctx.device,
                                torch.float32)
        rng = np.random.default_rng(ctx.seed)
        d, V = ctx.spec["d_model"], ctx.spec["vocab_size"]
        heads = {}
        heads["q1_head"] = gpt.init_head(rng, d, V, ctx.device)
        heads["v_head"] = gpt.init_head(rng, d, 1, ctx.device)
        heads["q2_head"] = gpt.init_head(rng, d, V, ctx.device)
        batches = self.recorded["rows"]
        if drop_half:
            batches = [b[:len(b) // 2] for b in batches]
        cfg = self.cfg_dict
        out = ref_ilql.updates(sd, heads, ctx.spec, self.rows, self.scores,
                               batches, self.width, self.pad_id,
                               cfg["method"], cfg["train"], ctx.device, prec,
                               rows_per_block=cell["reference_rows"])
        return {"losses": out["losses"],
                "grad": leaf_norms(out["grad_tensors"], ctx.spec),
                "change": leaf_norms(out["change"], ctx.spec)}

    def half_fault(self):
        """The reference with half of each batch left out (a fault)."""
        return self.reference(gpt.Precision("float32"), drop_half=True)

    @staticmethod
    def gaps(ours, ref):
        loss = loss_gap(ours["losses"], ref["losses"])
        skip = small_gradient_leaves(ref["grad"])
        return {"loss_gap": loss,
                "grad_gap": max(leaf_gaps(ours["grad"], ref["grad"]).values()),
                "change_gap": max(leaf_gaps(ours["change"], ref["change"],
                                            skip).values())}

    def check(self):
        ref = self.reference(gpt.Precision("float32"))
        gaps = self.gaps(self.recorded, ref)
        limits = self.ctx.cell["limits"]
        return [(k, gaps[k], limits[k]) for k in limits]


def make(ctx):
    return ILQL(ctx)
