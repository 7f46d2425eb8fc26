"""Resume in the port: a restored trainer continues exactly where the
saved one was (after tests/test_checkpoint.py):

- PPO: two updates, save, two more; a fresh trainer from another seed
  restores and takes the same two updates: params, optimizer state
  (count, mu, nu), the sampling generator's state and the KL
  coefficient are bit-identical on the CPU;
- ILQL at full unfreeze (zero-size frozen leaves, the empty frozen
  embed, the target heads) the same way;
- kill and continue through ``learn()``: ``resume_from`` picks up
  iter_count, params and the KL state from disk and runs to
  ``total_steps``; a second ``learn()`` does not restore again;
- the durability drive on the port's ``ilql_randomwalks``: SIGKILL it
  once two ``step_*`` directories exist, relaunch it with ``resume_from:
  auto``, and it starts at ``LATEST``'s step, keeps at most two
  committed directories and leaves no staging behind.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.test_ppo_e2e import PROMPTS, make_config, reward_fn
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.data.ilql_types import ILQLBatch
from trlx_tpu_torch.trainers import _leaves
from trlx_tpu_torch.utils.checkpoint import is_valid_checkpoint
from trlx_tpu_torch.utils.loading import (
    get_model,
    get_orchestrator,
    get_pipeline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_state(a, b):
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(_leaves(a.opt_state), _leaves(b.opt_state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(torch.rand(4, generator=a.generator),
                       torch.rand(4, generator=b.generator))


def _ppo(tmp_path, seed=0, **train):
    jcfg = make_config(total_steps=8, epochs=2, num_rollouts=16,
                       chunk_size=16, batch_size=16, ppo_epochs=1)
    cfg = TRLConfig.from_dict(jcfg.to_nested_dict())
    cfg.train.seed = seed
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    trainer = get_model("JaxPPOTrainer")(cfg, device="cpu")
    pipeline = get_pipeline("PPOPipeline")(PROMPTS, trainer.tokenizer, cfg)
    orch = get_orchestrator("PPOOrchestrator")(trainer, pipeline,
                                               reward_fn=reward_fn,
                                               chunk_size=16)
    return cfg, trainer, orch


def test_ppo_save_restore_next_step_identical(tmp_path):
    cfg, trainer, orch = _ppo(tmp_path)
    orch.make_experience(16)
    batch = next(iter(trainer.store.create_loader(16, shuffle=False)))
    for _ in range(2):
        trainer.train_step(batch)
    trainer.iter_count = 2
    trainer.kl_ctl.value = 0.123
    trainer.save()
    for _ in range(2):
        trainer.train_step(batch)

    _, resumed, _ = _ppo(tmp_path, seed=7)
    resumed.load(cfg.train.checkpoint_dir)
    assert resumed.iter_count == 2 and resumed.kl_ctl.value == 0.123
    assert int(resumed.opt_state["count"]) == 2
    for _ in range(2):
        resumed.train_step(batch)
    _assert_same_state(trainer, resumed)


def _ilql_config(seed=0):
    return TRLConfig.from_dict({
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxILQLTrainer", "num_layers_unfrozen": -1,
            "model_spec": {"vocab_size": 16, "n_layer": 2, "n_head": 2,
                           "d_model": 16, "n_positions": 32},
            "compute_dtype": "float32",
        },
        "train": {
            "n_ctx": 32, "epochs": 1, "total_steps": 100, "batch_size": 8,
            "grad_clip": 1.0, "lr_ramp_steps": 1, "lr_decay_steps": 100,
            "weight_decay": 1e-6, "learning_rate_init": 3e-3,
            "learning_rate_target": 1e-3, "log_interval": 10**9,
            "checkpoint_interval": 10**9, "eval_interval": 10**9,
            "pipeline": "OfflinePipeline",
            "orchestrator": "OfflineOrchestrator", "input_size": 4,
            "gen_size": 6, "seed": seed,
        },
        "method": {"name": "ilqlconfig", "tau": 0.7, "gamma": 0.99,
                   "cql_scale": 0.1, "awac_scale": 1.0, "alpha": 1.0,
                   "steps_for_target_q_sync": 2, "beta": 4.0,
                   "two_qs": True, "top_k": 20},
    })


def test_ilql_save_restore_next_step_identical(tmp_path):
    trainer = get_model("JaxILQLTrainer")(_ilql_config(), device="cpu")
    assert trainer.params["frozen_base"]["embed"] == {}
    assert trainer.params["frozen_base"]["blocks"]["attn"]["wq"].shape[0] \
        == 0
    rng = np.random.default_rng(0)
    batch = ILQLBatch(
        input_ids=torch.from_numpy(rng.integers(0, 16, (8, 12))
                                   .astype(np.int32)),
        attention_mask=torch.ones((8, 12), dtype=torch.int32),
        rewards=torch.from_numpy(rng.standard_normal((8, 11))
                                 .astype(np.float32)))

    def steps(t, n):
        for _ in range(n):
            t.train_step(batch)
            t.sync_targets()
            t.iter_count += 1

    steps(trainer, 2)
    trainer.save(str(tmp_path / "ck"))
    steps(trainer, 2)
    resumed = get_model("JaxILQLTrainer")(_ilql_config(seed=7),
                                          device="cpu")
    resumed.load(str(tmp_path / "ck"))
    assert resumed.iter_count == 2
    steps(resumed, 2)
    _assert_same_state(trainer, resumed)


def test_resume_from_kill_and_continue(tmp_path):
    cfg, trainer, orch = _ppo(tmp_path, checkpoint_interval=2,
                              total_steps=4, epochs=100)
    orch.make_experience(16)
    trainer.learn(log_fn=lambda s: None)
    assert trainer.iter_count == 4
    saved = [p.detach().clone() for p in _leaves(trainer.params)]
    saved_kl = trainer.kl_ctl.value

    _, resumed, orch2 = _ppo(tmp_path, seed=9,
                             resume_from=cfg.train.checkpoint_dir,
                             checkpoint_interval=10**9, total_steps=8,
                             epochs=100)
    assert resumed._resumed and resumed.iter_count == 4
    assert resumed.kl_ctl.value == saved_kl
    for a, b in zip(saved, _leaves(resumed.params)):
        assert torch.equal(a, b)
    orch2.make_experience(16)
    resumed.learn(log_fn=lambda s: None)
    assert resumed.iter_count == 8
    resumed.config.train.total_steps = 12
    orch2.make_experience(16)
    resumed.learn(log_fn=lambda s: None)  # resume is once per process
    assert resumed.iter_count == 12


def _committed(run):
    return sorted(e for e in os.listdir(run)
                  if e.startswith("step_")
                  and is_valid_checkpoint(os.path.join(run, e)))


def _latest_step(run):
    """The step ``LATEST`` names, or -1 before the first commit (the file
    is replaced atomically, so a read sees a whole name)."""
    try:
        with open(os.path.join(run, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (OSError, ValueError, IndexError):
        return -1


def test_durability_drive_sigkill_and_relaunch(tmp_path):
    run = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "trlx_tpu_torch.examples.ilql_randomwalks",
           "--device", "cpu", "--checkpoint-dir", run,
           "--checkpoint-interval", "4", "--keep-checkpoints", "2",
           "--resume-from", "auto"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    first = subprocess.Popen(cmd + ["--epochs", "10"], cwd=REPO, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    try:
        # wait for the commit point the checks below read: LATEST naming
        # step_8 or later (a save renames step_<n> into place first and
        # writes LATEST after it, so two valid directories can precede
        # the second LATEST). A kill during a later save may leave a
        # committed step newer than LATEST names; the relaunch resumes
        # from LATEST's step, which is what is checked.
        deadline = time.time() + 120
        while time.time() < deadline:
            if _latest_step(run) >= 8:
                break
            assert first.poll() is None, "the run ended before two saves"
            time.sleep(0.05)
        else:
            raise AssertionError("LATEST named no step >= 8 in 120 s")
    finally:
        first.send_signal(signal.SIGKILL)
        first.wait(timeout=60)
    with open(os.path.join(run, "LATEST")) as f:
        latest = int(f.read().strip().split("_")[1])
    assert latest >= 8

    out = subprocess.run(cmd + ["--epochs", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first_line = out.stdout.splitlines()[0]
    assert first_line == str({"start_iter": latest})
    committed = _committed(run)
    assert 1 <= len(committed) <= 2
    assert not any(".tmp-" in e or ".old-" in e for e in os.listdir(run))
    newest = max(committed, key=lambda e: int(e.split("_")[1]))
    with open(os.path.join(run, "LATEST")) as f:
        assert f.read().strip() == newest


def test_serve_cli_restores_a_run_directory(tmp_path):
    """``python -m trlx_tpu_torch.serve --checkpoint <run dir>``: the
    newest step, the config from meta.json (``--config`` overrides it),
    and decode views equal to the trainer's, so greedy tokens equal an
    engine built from the trainer's in-memory params."""
    import json

    from trlx_tpu_torch.models.params import decode_views_from_numpy
    from trlx_tpu_torch.serve import InferenceEngine, ServeConfig
    from trlx_tpu_torch.serve import SlotScheduler
    from trlx_tpu_torch.serve.__main__ import build_engine, build_parser

    cfg, trainer, orch = _ppo(tmp_path, checkpoint_interval=2,
                              total_steps=4, epochs=100)
    orch.make_experience(16)
    trainer.learn(log_fn=lambda s: None)
    run = cfg.train.checkpoint_dir
    flags = ["--checkpoint", run, "--device", "cpu", "--buckets", "2x8x8",
             "--slots", "2", "--page-size", "4", "--no-warmup"]
    engine = build_engine(build_parser().parse_args(flags))
    assert engine.checkpoint_path.endswith("step_4")
    assert engine.config.to_nested_dict() == cfg.to_nested_dict()

    greedy = cfg.to_nested_dict()
    greedy["method"]["gen_kwargs"] = {"max_length": 8, "do_sample": False}
    path = tmp_path / "greedy.json"
    path.write_text(json.dumps(greedy))
    restored = build_engine(build_parser().parse_args(
        flags + ["--config", str(path)]))
    live = InferenceEngine(
        TRLConfig.from_dict(greedy),
        serve=ServeConfig(buckets=[[2, 8, 8]], slots=2, page_size=4),
        views=decode_views_from_numpy(trainer.params,
                                      trainer.policy.spec, 1),
        device="cpu")
    outs = []
    for engine in (restored, live):
        sched = SlotScheduler(engine)
        reqs = [sched.submit([5, 6, 7], max_new_tokens=6),
                sched.submit([9, 10], max_new_tokens=6)]
        sched.start()
        try:
            outs.append([r.wait(timeout=60).result for r in reqs])
        finally:
            sched.stop()
    assert outs[0] == outs[1] and len(outs[0][0]) == 6

    ilql = str(tmp_path / "ilql")
    get_model("JaxILQLTrainer")(_ilql_config(), device="cpu").save(ilql)
    with pytest.raises(NotImplementedError, match="ilqlconfig"):
        build_engine(build_parser().parse_args(
            ["--checkpoint", ilql, "--device", "cpu"]))


def test_shipped_configs_save_at_their_first_interval(tmp_path):
    """configs/ilql_config.yml and configs/ppo_config.yml through the port
    on a tiny from-config model (the port has no pretrained import): the
    learn loop saves ``step_<checkpoint_interval>`` plus LATEST where the
    port used to raise. ILQL runs to its shipped interval (100); PPO's
    shipped interval is 1000 passes, so it runs to 8 with the interval
    set to 8. ppo_config.yml's run-supervisor block runs as shipped
    (stall_timeout 300, stall_grace 120, host_call_timeout 60): the
    watchdog is armed through learn() and the reward seam is bounded,
    and telemetry.json lands in the run directory."""
    tiny = {"model_path": "from-config", "tokenizer_path": "byte",
            "compute_dtype": "float32",
            "model_spec": {"vocab_size": 257, "n_layer": 1, "n_head": 2,
                           "d_model": 16, "n_positions": 64}}

    cfg = TRLConfig.load_yaml("configs/ilql_config.yml")
    for k, v in tiny.items():
        setattr(cfg.model, k, v)
    interval = cfg.train.checkpoint_interval
    assert interval == 100
    cfg.train.checkpoint_dir = str(tmp_path / "ilql")
    cfg.train.total_steps, cfg.train.epochs = interval, 10**3
    trainer = get_model(cfg.model.model_type)(cfg, device="cpu")
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 256, 10).tolist() for _ in range(80)]
    get_orchestrator(cfg.train.orchestrator)(
        trainer, rows, [], reward_fn=lambda samples: [0.0] * len(samples))
    trainer.learn(log_fn=lambda s: None)
    assert trainer.iter_count == interval
    run = cfg.train.checkpoint_dir
    assert _committed(run) == [f"step_{interval}"]
    with open(os.path.join(run, "LATEST")) as f:
        assert f.read() == f"step_{interval}"

    cfg = TRLConfig.load_yaml("configs/ppo_config.yml")
    for k, v in tiny.items():
        setattr(cfg.model, k, v)
    cfg.train.checkpoint_dir = str(tmp_path / "ppo")
    assert (cfg.train.stall_timeout, cfg.train.stall_grace,
            cfg.train.host_call_timeout) == (300, 120, 60)
    cfg.train.checkpoint_interval = cfg.train.total_steps = 8
    trainer = get_model(cfg.model.model_type)(cfg, device="cpu")
    assert trainer.guard_on  # the shipped max_bad_steps: 5
    pipeline = get_pipeline("PPOPipeline")(PROMPTS * 4, trainer.tokenizer,
                                           cfg)
    orch = get_orchestrator("PPOOrchestrator")(
        trainer, pipeline, reward_fn=reward_fn,
        chunk_size=cfg.method.chunk_size)
    orch.make_experience(cfg.method.num_rollouts)
    trainer.learn(log_fn=lambda s: None)
    assert trainer.iter_count == 8
    assert _committed(cfg.train.checkpoint_dir) == ["step_8"]
    sup = trainer.supervisor
    assert (sup.stall_timeout, sup.stall_grace) == (300, 120)
    assert sup.stalls == 0 and not sup.escalated
    assert {"ppo_update", "checkpoint_save"} <= set(sup.first_call_s)
    assert os.path.isfile(os.path.join(cfg.train.checkpoint_dir,
                                       "telemetry.json"))
