"""One process of the 4-process gloo worlds of
tests/test_torch_parallel_dist.py and tests/test_torch_sp_pp_dist.py
(torch only, no JAX):

    python tests/torch_parallel_worker.py <init_method> <rank> <world> <dir>
        [mesh | sp_pp]

reads ``<dir>/inputs.pt`` (configs, weights and batches the test wrote),
runs the scenario set named last (``mesh``, the default: dp / fsdp /
tp; ``sp_pp``: sequence and pipeline parallelism) on its meshes, writes
``<dir>/rank<r>.pt`` with what it saw and prints ``WORKER OK <rank>``
last. Whole tensors gathered
from the mesh are kept on rank 0 only; every rank keeps SHA-256 digests
of what must agree across ranks.
"""

import hashlib
import os
import sys

import torch


def digest(tree) -> str:
    """SHA-256 over a tree's leaves (whole tensors, gathered first)."""
    from trlx_tpu_torch.models.transformer import tree_map
    from trlx_tpu_torch.parallel.sharding import whole

    h = hashlib.sha256()

    def add(x):
        x = whole(x).detach().contiguous().cpu()
        h.update(x.view(torch.uint8).numpy().tobytes() if x.numel()
                 else b"")

    tree_map(add, tree)
    return h.hexdigest()


def leaves_are_dtensors(tree) -> bool:
    from trlx_tpu_torch.models.transformer import tree_map
    from trlx_tpu_torch.parallel.sharding import is_dtensor

    flags = []
    tree_map(lambda x: flags.append(is_dtensor(x)), tree)
    return all(flags)


def ppo_batch(data):
    from trlx_tpu_torch.data.ppo_types import PPORLBatch

    return PPORLBatch(**{k: torch.from_numpy(v) for k, v in data.items()})


def ilql_batch(data):
    from trlx_tpu_torch.data.ilql_types import ILQLBatch

    return ILQLBatch(**{k: torch.from_numpy(v) for k, v in data.items()})


def floats(stats):
    return {k: float(v) for k, v in stats.items()}


def to_numpy(tree):
    """A tree's whole tensors as numpy COPIES (a gather: every rank takes
    part); the trainer's later in-place updates do not reach them."""
    from trlx_tpu_torch.models.params import hydra_to_numpy
    from trlx_tpu_torch.models.transformer import tree_map

    return tree_map(lambda x: x.copy(), hydra_to_numpy(tree))


def ppo_trainer(inputs, mesh, params=None):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_model

    cfg = TRLConfig.from_dict(inputs["ppo_config"])
    return get_model("JaxPPOTrainer")(
        cfg, device="cpu", mesh=mesh,
        params=inputs["ppo_params"] if params is None else params)


def ppo_fused(inputs, rank):
    """One PPO step through the flash seam (every sequence length fused;
    the kernels' plain versions on the CPU) on {fsdp: 2, tp: 2}, where
    the blocks run Megatron's tp compute and the seam gets this
    process's heads."""
    from trlx_tpu_torch.ops import flash_attention as tfa
    from trlx_tpu_torch.parallel import build_mesh

    tfa._MIN_FUSED_T = 0
    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    tr = ppo_trainer({**inputs, "ppo_config": inputs["ppo_fused_config"]},
                     mesh)
    stats = floats(tr.train_step(ppo_batch(inputs["ppo_batch"])))
    trainable = to_numpy(tr.params["trainable"])
    return {"tp": tr.tp is not None, "fused": tr.policy.attention_fn
            is not None, "stats": stats,
            "trainable": trainable if rank == 0 else None}


def ppo_steps(inputs, rank, mesh_config, workdir, checkpoints):
    """One PPO step from the shared weights; on the {fsdp: 2, tp: 2} mesh
    also the checkpoint round trips: save after the step (for a plain
    process to restore), a second step, and the plain process's
    checkpoint restored into a fresh mesh trainer, then its next step."""
    from trlx_tpu_torch.parallel import build_mesh

    mesh = build_mesh(mesh_config, "cpu")
    tr = ppo_trainer(inputs, mesh)
    out = {"dtensors": leaves_are_dtensors(tr.params)
           and leaves_are_dtensors(tr.opt_state["mu"]),
           "tp": tr.tp is not None}
    out["stats"] = floats(tr.train_step(ppo_batch(inputs["ppo_batch"])))
    trainable = to_numpy(tr.params["trainable"])
    out["digest"] = digest(tr.params["trainable"])
    if rank == 0:
        out["trainable"] = trainable
    if not checkpoints:
        return out
    tr.save(os.path.join(workdir, "ckpt_mesh"))
    saved = to_numpy(tr.params)
    out["saved"] = saved if rank == 0 else None
    out["next_stats"] = floats(tr.train_step(ppo_batch(inputs["ppo_batch2"])))
    nxt = to_numpy(tr.params["trainable"])
    if rank == 0:
        out["next_trainable"] = nxt
    # the reverse: the plain process's checkpoint into a fresh mesh trainer
    back = ppo_trainer(inputs, mesh)
    back.load(inputs["plain_ckpt"])
    out["restored_dtensors"] = leaves_are_dtensors(back.params)
    restored = to_numpy(back.params)
    out["restored_digest"] = digest(back.params)
    out["restored_iter"] = back.iter_count
    out["restored_stats"] = floats(back.train_step(
        ppo_batch(inputs["ppo_batch2"])))
    after = to_numpy(back.params["trainable"])
    if rank == 0:
        out["restored"], out["restored_next"] = restored, after
    return out


def ilql_step(inputs, rank):
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.loading import get_model

    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    tr = get_model("JaxILQLTrainer")(
        TRLConfig.from_dict(inputs["ilql_config"]), device="cpu",
        params=inputs["ilql_params"], mesh=mesh)
    out = {"dtensors": leaves_are_dtensors(tr.params), "steps": [],
           "tp": tr.tp is not None}
    for _ in range(2):  # the ramp makes the first step's lr 0
        out["steps"].append(floats(tr.train_step(
            ilql_batch(inputs["ilql_batch"]))))
    tr.sync_targets()
    out["digest"] = digest(tr.params)
    trainable = to_numpy(tr.params["trainable"])
    target = to_numpy(tr.params["target"])
    if rank == 0:
        out["trainable"], out["target"] = trainable, target
    return out


def gptj_learn(inputs, rank):
    """configs/ppo_gptj.yml at toy widths on {dp: -1, fsdp: 2, tp: 2}:
    make_experience and learn; rank 1's reward_fn answers differently and
    must be overridden by rank 0's."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import (
        get_model,
        get_orchestrator,
        get_pipeline,
    )

    config = TRLConfig.from_dict(inputs["gptj_config"])
    trainer = get_model(config.model.model_type)(config, device="cpu")

    def reward_fn(samples):
        scores = [sum(c.islower() for c in s) / max(len(s), 1)
                  for s in samples]
        return [s + 100.0 * rank for s in scores]

    pipeline = get_pipeline(config.train.pipeline)(
        inputs["prompts"], trainer.tokenizer, config)
    orch = get_orchestrator(config.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_fn,
        chunk_size=config.method.chunk_size)
    info = orch.make_experience(config.method.num_rollouts)
    logs = []
    trainer.learn(log_fn=logs.append)
    return {
        "mesh": dict(zip(trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
        "mean_score": info["mean_score"],
        "losses": [entry["loss"] for entry in logs if "loss" in entry],
        "digest": digest(trainer.params["trainable"]),
        "iter": trainer.iter_count,
    }


def ppo_resume(inputs, rank, workdir):
    """PPO on {dp: 2, tp: 2} with the reward model built from the
    trainer's trunk, on the mesh (ppo_tldr's wiring): make_experience,
    learn() with a step checkpoint, then a fresh mesh trainer resumed
    from the run directory (``resume_from: auto``)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.examples import ppo_tldr
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline

    mesh = build_mesh({"dp": 2, "tp": 2}, "cpu")
    cfg = dict(inputs["ppo_config"])
    run_dir = os.path.join(workdir, "ppo_run")
    cfg["train"] = dict(cfg["train"], total_steps=2, checkpoint_interval=2,
                        checkpoint_dir=run_dir)
    trainer = ppo_trainer({**inputs, "ppo_config": cfg}, mesh)
    reward_model = ppo_tldr.build_reward_model(trainer.config, trainer)
    config = trainer.config
    pipeline = get_pipeline(config.train.pipeline)(
        inputs["prompts"], trainer.tokenizer, config)
    orch = get_orchestrator(config.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_model,
        chunk_size=config.method.chunk_size)
    info = orch.make_experience(config.method.num_rollouts)
    trainer.learn(log_fn=lambda stats: None)
    cfg["train"] = dict(cfg["train"], resume_from="auto")
    resumed = ppo_trainer({**inputs, "ppo_config": cfg}, mesh)
    return {"mean_score": info["mean_score"],
            "rm_dtensors": leaves_are_dtensors(reward_model.params),
            "store": digest(trainer.store._stacked().rewards),
            "digest": digest(trainer.params),
            "opt_digest": digest(trainer.opt_state["nu"]),
            "resumed_digest": digest(resumed.params),
            "resumed_opt_digest": digest(resumed.opt_state["nu"]),
            "iter": trainer.iter_count, "resumed_iter": resumed.iter_count,
            "steps": sorted(os.listdir(run_dir))}


def ilql_learn(inputs, rank):
    """ILQL learn() on {fsdp: 2, tp: 2} through the offline orchestrator:
    rank 1's reward_fn answers differently and must be overridden by rank
    0's; a partial last batch is dropped; the eval's odd prompt batch is
    padded and sliced back."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.loading import get_model, get_orchestrator

    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    cfg = TRLConfig.from_dict(inputs["ilql_config"])
    cfg.train.batch_size = 4
    trainer = get_model("JaxILQLTrainer")(
        cfg, device="cpu", params=inputs["ilql_params"], mesh=mesh)

    def reward_fn(samples):
        scores = [float(sum(row) % 7) for row in samples]
        return scores[::-1] if rank == 1 else scores

    get_orchestrator("OfflineOrchestrator")(
        trainer, inputs["ilql_rows"], inputs["ilql_prompts"],
        reward_fn=reward_fn)
    logs = []
    trainer.learn(log_fn=logs.append)
    evals = [entry for entry in logs if "reward" in entry]
    return {"iter": trainer.iter_count,
            "rewards": digest(torch.cat([torch.as_tensor(r) for r in
                                         trainer.train_store.rewards])),
            "digest": digest(trainer.params),
            "eval": evals[0]["reward"] if evals else None}


def generation(inputs, rank):
    """Greedy decode on {dp: 2, tp: 2} from an odd prompt batch (padded
    to dp * fsdp and sliced back), and sampled decode from an even one."""
    from trlx_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"dp": 2, "tp": 2}, "cpu")
    tr = ppo_trainer(inputs, mesh)
    out = {}
    for name, sampling in (("greedy", False), ("sampled", True)):
        tr.gen_config = tr.gen_config._replace(
            sampling=tr.gen_config.sampling._replace(do_sample=sampling))
        tr.generator.manual_seed(inputs["gen_seed"])
        res = tr.generate(*inputs["gen_" + name])
        out[name] = res.gen_tokens.numpy()
        out[name + "_logprobs"] = res.gen_logprobs.numpy()
    return out


def reward_scores(inputs, rank):
    from trlx_tpu_torch.models.reward import DeviceRewardModel, RewardModel
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.tokenizer import load_tokenizer

    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    model = RewardModel(spec=inputs["rm_spec"], compute_dtype=torch.float32)
    rm = DeviceRewardModel(model, inputs["rm_params"], load_tokenizer("byte"),
                           device="cpu", mesh=mesh)
    return {"scores": rm.score_tokens(torch.from_numpy(inputs["rm_tokens"]),
                                      torch.from_numpy(inputs["rm_mask"]))
            .numpy(),
            "dtensors": leaves_are_dtensors(rm.params)}


def flash_seam(inputs, rank):
    """The flash seam on {fsdp: 2, tp: 2} at T 128 on the CPU (the plain
    versions): global DTensor inputs against the seam without a mesh
    (and dense attention on the real query positions: the kernels' left
    pad rows differ from it, as in one process), and this process's rows
    (the trainers' forward) with gradients."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from trlx_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        make_flash_attention_fn,
    )
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.parallel.sharding import rows_of

    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    fn, plain_fn = make_flash_attention_fn(mesh=mesh), \
        make_flash_attention_fn()
    q, k, v, w = (torch.from_numpy(inputs["attn"][n])
                  for n in ("q", "k", "v", "w"))
    mask = torch.from_numpy(inputs["attn"]["mask"])
    real = mask.bool()
    plain = plain_fn(q, k, v, mask)
    dense = flash_attention_reference(q, k, v, mask)
    rep = [Replicate()] * mesh.ndim
    glob = fn(*(distribute_tensor(x, mesh, rep) for x in (q, k, v, mask)))
    glob = glob.full_tensor()
    out = {"global_err": float((glob - plain).abs().max()),
           "dense_err": float((glob - dense)[real].abs().max())}
    # rows of the batch, with the gradients of a weighted sum
    ql, kl, vl = (rows_of(x, mesh).clone().requires_grad_(True)
                  for x in (q, k, v))
    o = fn(ql, kl, vl, rows_of(mask, mesh))
    (o * rows_of(w, mesh)).sum().backward()
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    ref = plain_fn(qr, kr, vr, mask)
    (ref * w).sum().backward()
    out["rows_err"] = float((o - rows_of(ref, mesh)).abs().max())
    out["grad_err"] = max(float((a.grad - rows_of(b.grad, mesh)).abs().max())
                          for a, b in ((ql, qr), (kl, kr), (vl, vr)))
    # this process's rows and heads (a tp-sharded model's forward)
    tp_fn = make_flash_attention_fn(mesh=mesh, tp_heads=True)
    t = mesh.get_coordinate()[-1]
    heads = slice(2 * t, 2 * t + 2)  # H 4 over tp 2

    def mine(x):
        return rows_of(x, mesh)[:, :, heads].clone().requires_grad_(True)

    qh, kh, vh = (mine(x) for x in (q, k, v))
    o = tp_fn(qh, kh, vh, rows_of(mask, mesh))
    (o * rows_of(w, mesh)[:, :, heads]).sum().backward()
    out["tp_heads_err"] = float(
        (o - rows_of(ref, mesh)[:, :, heads]).abs().max())
    out["tp_heads_grad_err"] = max(
        float((a.grad - rows_of(b.grad, mesh)[:, :, heads]).abs().max())
        for a, b in ((qh, qr), (kh, kr), (vh, vr)))
    return out


def adafactor(inputs, rank):
    """Two Adafactor steps on sharded leaves (factored and not) on
    {fsdp: 2, tp: 2}; the whole updated leaves."""
    from torch.distributed.tensor import distribute_tensor

    from trlx_tpu_torch.parallel import build_mesh, shard_params
    from trlx_tpu_torch.trainers import Adafactor
    from trlx_tpu_torch.utils import cosine_schedule

    mesh = build_mesh({"fsdp": 2, "tp": 2}, "cpu")
    data = inputs["adafactor"]
    params = shard_params(mesh, {k: torch.from_numpy(v)
                                 for k, v in data["params"].items()})
    leaves = [params[k] for k in sorted(params)]
    opt = Adafactor(cosine_schedule(1e-2, 10), 1.0, 1e-4)
    state = opt.init(leaves)
    for grads in data["grads"]:
        gs = [distribute_tensor(torch.from_numpy(grads[k]), mesh,
                                leaves[i].placements, src_data_rank=None)
              for i, k in enumerate(sorted(params))]
        opt.step(leaves, gs, state)
    return {"leaves": [p.full_tensor().numpy() for p in leaves]}


def sp_pp_step(inputs, rank, name, mesh_config):
    """One PPO step and two ILQL steps (the ramp makes the first lr 0)
    on ``mesh_config`` from the shared weights; on the pp mesh also the
    stage's slab, ``pp_apply_blocks`` called directly, and the PPO
    trainer's checkpoint, saved after its step, restored into a fresh
    mesh trainer (and, by the test, into a plain process)."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.loading import get_model

    mesh = build_mesh(mesh_config, "cpu")
    key = "pp" if "pp" in mesh_config else "sp"
    tr = ppo_trainer({**inputs, "ppo_config": inputs[key + "_ppo_config"],
                      "ppo_params": inputs[key + "_ppo_params"]}, mesh)
    out = {"sp": tr.sp is not None and tr.policy.sp is tr.sp,
           "pp": tr.policy._pp_active(), "tp": tr.tp is not None,
           "ring": getattr(tr.policy.attention_fn, "takes_raw_mask",
                           False)}
    out["ppo_stats"] = floats(tr.train_step(ppo_batch(inputs["ppo_batch"])))
    trainable = to_numpy(tr.params["trainable"])
    out["ppo_digest"] = digest(tr.params)
    if rank == 0:
        out["ppo_trainable"] = trainable
    if key == "pp":
        wq = tr.params["frozen_base"]["blocks"]["attn"]["wq"]
        out["pp_slab"] = tuple(wq.to_local().shape)
        out["pp_direct_err"] = pp_direct(inputs, mesh, tr.policy.spec)
        tr.save(os.path.join(inputs["workdir"], "ckpt_pp"))
        saved = to_numpy(tr.params)
        out["saved"] = saved if rank == 0 else None
        back = ppo_trainer({**inputs,
                            "ppo_config": inputs["pp_ppo_config"],
                            "ppo_params": inputs["pp_ppo_params"]}, mesh)
        back.load(os.path.join(inputs["workdir"], "ckpt_pp"))
        out["restored_digest"] = digest(back.params)
    itr = get_model("JaxILQLTrainer")(
        TRLConfig.from_dict(inputs[key + "_ilql_config"]), device="cpu",
        params=inputs[key + "_ilql_params"], mesh=mesh)
    out["ilql_steps"] = [floats(itr.train_step(ilql_batch(
        inputs["sp_ilql_batch"]))) for _ in range(2)]
    itrainable = to_numpy(itr.params["trainable"])
    out["ilql_digest"] = digest(itr.params)
    if rank == 0:
        out["ilql_trainable"] = itrainable
    return out


def pp_direct(inputs, mesh, spec, blocks=None, n_micro=2):
    """``pp_apply_blocks`` on ``shard_blocks_pp``'s placement of a trunk
    (by default the 2 frozen layers; this process's rows of the test's
    activations) against ``apply_blocks`` on the whole trunk: the largest
    difference."""
    from trlx_tpu_torch.models.transformer import (
        apply_blocks,
        causal_mask_bias,
        positions_from_mask,
        tree_map,
    )
    from trlx_tpu_torch.ops.pipeline_parallel import (
        pp_apply_blocks,
        shard_blocks_pp,
    )
    from trlx_tpu_torch.parallel.sharding import rows_of

    blocks = tree_map(torch.as_tensor, inputs["pp_blocks"] if blocks is None
                      else blocks)
    h, mask = (rows_of(torch.from_numpy(inputs[k]), mesh)
               for k in ("pp_h", "pp_mask"))
    bias, pos = causal_mask_bias(mask), positions_from_mask(mask)
    out = pp_apply_blocks(mesh, shard_blocks_pp(mesh, blocks), spec, h,
                          bias, pos, n_micro=n_micro)
    return float((out - apply_blocks(blocks, spec, h, bias, pos))
                 .abs().max())


def sp_pp_rollouts(inputs, rank, mesh_config, config=None):
    """make_experience on ``mesh_config`` (with ``config``, by default
    the sp or pp PPO config): scoring under sp or pp, the decode dense on
    the whole trunk; the store (the same on every rank) and rank 0's copy
    of it."""
    from trlx_tpu_torch.parallel import build_mesh
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline

    mesh = build_mesh(mesh_config, "cpu")
    key = "pp" if "pp" in mesh_config else "sp"
    tr = ppo_trainer({**inputs, "ppo_config": config
                      or inputs[key + "_ppo_config"],
                      "ppo_params": inputs[key + "_ppo_params"]}, mesh)
    cfg = tr.config

    def reward_fn(samples):
        return [sum(c.islower() for c in s) / max(len(s), 1)
                for s in samples]

    pipeline = get_pipeline(cfg.train.pipeline)(inputs["prompts"],
                                                tr.tokenizer, cfg)
    orch = get_orchestrator(cfg.train.orchestrator)(
        tr, pipeline, reward_fn=reward_fn, chunk_size=cfg.method.chunk_size)
    orch.make_experience(cfg.method.num_rollouts)
    store = tr.store._stacked()
    out = {"digest": digest({k: getattr(store, k) for k in
                             ("query_tensors", "response_tensors",
                              "logprobs", "values", "rewards")})}
    if rank == 0:
        out["store"] = {k: getattr(store, k).numpy().copy() for k in
                        ("response_tensors", "logprobs", "values",
                         "rewards")}
    return out


def sp_long_prompt(inputs, rank):
    """PPO on {dp: 2, sp: 2} with prompts longer than a chunk (input 8,
    gen 4: rank 0's 6 positions end before the response window starts):
    one step, and make_experience."""
    from trlx_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"dp": 2, "sp": 2}, "cpu")
    tr = ppo_trainer({**inputs, "ppo_config": inputs["long_ppo_config"],
                      "ppo_params": inputs["sp_ppo_params"]}, mesh)
    out = {"ppo_stats": floats(tr.train_step(ppo_batch(
        inputs["long_ppo_batch"])))}
    trainable = to_numpy(tr.params["trainable"])
    out["ppo_digest"] = digest(tr.params)
    if rank == 0:
        out["ppo_trainable"] = trainable
    out["rollout"] = sp_pp_rollouts(inputs, rank, {"dp": 2, "sp": 2},
                                    inputs["long_ppo_config"])
    return out


def pp_four_stages(inputs, rank):
    """``pp_apply_blocks`` on {pp: 4}: the 2 frozen layers twice over, a
    layer a stage, 4 microbatches, so the first ticks leave stages with
    nothing to send or receive."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.transformer import tree_map
    from trlx_tpu_torch.parallel import build_mesh

    mesh = build_mesh({"pp": 4}, "cpu")
    blocks = tree_map(lambda x: torch.cat([torch.tensor(x)] * 2),
                      inputs["pp_blocks"])
    spec = TRLConfig.from_dict(inputs["pp_ppo_config"]).model.resolve_spec()
    return {"err": pp_direct(inputs, mesh, spec, blocks, n_micro=4)}


def sp_pp_refusals(inputs, rank):
    """Construction on the world's meshes with trlx_tpu's refusals: a
    trunk of zero frozen layers under pp, T not divisible by sp."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_model

    out = {}
    for name in ("zero_frozen", "t_sp"):
        cfg = TRLConfig.from_dict(inputs["refusal_" + name])
        try:
            get_model("JaxPPOTrainer")(cfg, device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def sp_pp(inputs, rank):
    return {
        "dp_sp": sp_pp_step(inputs, rank, "dp_sp", {"dp": 2, "sp": 2}),
        "sp_tp": sp_pp_step(inputs, rank, "sp_tp", {"sp": 2, "tp": 2}),
        "pp_fsdp": sp_pp_step(inputs, rank, "pp_fsdp", {"pp": 2, "fsdp": 2}),
        "rollout_sp": sp_pp_rollouts(inputs, rank, {"dp": 2, "sp": 2}),
        "rollout_pp": sp_pp_rollouts(inputs, rank, {"pp": 2, "fsdp": 2}),
        "long_prompt": sp_long_prompt(inputs, rank),
        "pp4": pp_four_stages(inputs, rank),
        "refusals": sp_pp_refusals(inputs, rank),
    }


def mesh(inputs, rank, workdir):
    return {
        "ppo_fsdp_tp": ppo_steps(inputs, rank, {"fsdp": 2, "tp": 2},
                                 workdir, checkpoints=True),
        "ppo_dp": ppo_steps(inputs, rank, {"dp": 4}, workdir,
                            checkpoints=False),
        "ppo_fused": ppo_fused(inputs, rank),
        "ilql": ilql_step(inputs, rank),
        "ilql_learn": ilql_learn(inputs, rank),
        "ppo_resume": ppo_resume(inputs, rank, workdir),
        "gptj": gptj_learn(inputs, rank),
        "generation": generation(inputs, rank),
        "reward": reward_scores(inputs, rank),
        "flash": flash_seam(inputs, rank),
        "adafactor": adafactor(inputs, rank),
    }


def main():
    init_method, rank, world, workdir = sys.argv[1:5]
    scenarios = sys.argv[5] if len(sys.argv) > 5 else "mesh"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from trlx_tpu_torch.parallel import initialize_runtime

    initialize_runtime(init_method, world, rank, "cpu")
    import torch.distributed as dist

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    if scenarios == "sp_pp":
        out = sp_pp({**inputs, "workdir": workdir}, rank)
    else:
        out = mesh(inputs, rank, workdir)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER OK {rank}", flush=True)


if __name__ == "__main__":
    main()
