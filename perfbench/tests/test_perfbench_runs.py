"""Whole runs of each cell at tiny widths on the CPU (the harness's look
for a card skipped): the one-line output, the program against the plain
reference, and the faults each cell can have, planted in the program,
coming out as not correct."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CELLS = sorted(tiny.OVERRIDES)
TRAINING = ["ilql-gpt2-imdb", "ppo-gptj6b-tldr"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_and_the_reference_agrees(cell, trace):
    rc, line = tiny.run(cell, seed=3000000019 + trace, trace=trace)
    assert rc == 0
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    e2e, layer = harness.metrics_of(harness.benchmark(), cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["metrics"]) <= {m["name"] for m in layer}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    for name, m in line["metrics"].items():
        assert np.isfinite(m["value"]), name
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def halve(cls, monkeypatch):
    """Half of every batch left out, the mean taken over the rest."""
    inner = cls.train_step

    def train_step(self, batch):
        n = len(batch.input_ids if hasattr(batch, "input_ids")
                else batch.query_tensors)
        return inner(self, batch.map(lambda x: x[: n // 2]))

    monkeypatch.setattr(cls, "train_step", train_step)


def trainer_class(cell):
    if cell.startswith("ilql"):
        from trlx_tpu_torch.trainers.ilql_trainer import JaxILQLTrainer

        return JaxILQLTrainer
    from trlx_tpu_torch.trainers.ppo_trainer import JaxPPOTrainer

    return JaxPPOTrainer


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        cell, monkeypatch):
    from trlx_tpu_torch import trainers

    def frozen(self, params, grads, state, ok=None, g_norm=None):
        return trainers.global_norm(grads) if g_norm is None else g_norm

    monkeypatch.setattr(trainers.AdamW, "step", frozen)
    rc, line = tiny.run(cell)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > 0.99


@pytest.mark.parametrize("cell", TRAINING)
def test_half_of_the_batch_left_out_is_not_correct(cell, monkeypatch):
    halve(trainer_class(cell), monkeypatch)
    rc, line = tiny.run(cell)
    assert rc == 0 and line["correct"] is False


def test_a_served_token_altered_where_it_is_produced_is_not_correct(
        monkeypatch):
    from trlx_tpu_torch.serve.slots import SlotPoolRuntime

    inner = SlotPoolRuntime.step
    vocab = tiny.SERVE["vocab_size"]

    def step(self, seed):
        tok, emitted, finished = inner(self, seed)
        return (tok + 1) % vocab, emitted, finished

    monkeypatch.setattr(SlotPoolRuntime, "step", step)
    rc, line = tiny.run("serve-gptj6b-sessions")
    assert rc == 0 and line["correct"] is False


def test_served_logits_altered_where_they_are_produced_are_not_correct(
        monkeypatch):
    """Every slot's carried logits raised by 0.5 after each step: the
    served tokens stay the same, the logits do not."""
    from trlx_tpu_torch.serve.slots import SlotPoolRuntime

    inner = SlotPoolRuntime.step

    def step(self, seed):
        out = inner(self, seed)
        self.state.logits.add_(0.5)
        return out

    monkeypatch.setattr(SlotPoolRuntime, "step", step)
    rc, line = tiny.run("serve-gptj6b-sessions")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] <= tiny.TIGHT["logit_gap"]
    assert line["checks"]["logit_diff"]["value"] > 0.4


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference one precision below the configuration's (float8 for
    its bf16) in the program's place, held to the cell's own limits."""
    from perfbench.reference import gpt

    def control(driver):
        inner = driver.release

        def release():
            inner()
            low = driver.reference(gpt.Precision("float8"))
            if isinstance(low, list):  # served: its logits, its tokens
                driver.recorded = [
                    dict(r, served=low_logits.argmax(-1).tolist(),
                         positions=list(range(len(low_logits))),
                         logits=low_logits)
                    for r, low_logits in zip(driver.recorded, low)]
                return
            ours = dict(driver.recorded, losses=low["losses"],
                        grad=low["grad"], change=low["change"])
            if "rollout" in low:  # the sampled tokens stay the program's
                ours["rollout"] = dict(ours["rollout"], **{
                    k: low["rollout"][k]
                    for k in ("logprobs", "values", "rewards")})
            driver.recorded = ours

        driver.release = release

    own = harness.load_json("workloads", f"{cell}.json")["limits"]
    rc, line = tiny.run(cell, patch=control, limits=own)
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_a_traced_step_holds_every_slot_it_served():
    """The paged-decode roofline's steps: the tokens handed over at one
    harvest are one step, so a step holds each live slot's context."""
    got = {}

    def keep(driver):
        inner = driver.window

        def window():
            out = inner()
            got.update(out["readings"])
            return out

        driver.window = window

    rc, line = tiny.run("serve-gptj6b-sessions", trace=1, patch=keep)
    assert rc == 0 and line["correct"] is True
    steps = got["paged_steps"]
    assert steps and max(len(contexts) for contexts in steps) > 1
    assert got["traced_flops"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.run(["--workload", "ilql-gpt2-imdb", "--seed", "1",
                      "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
