"""One process of the 4-process gloo world of
tests/test_torch_parallel_dist.py (torch only, no JAX):

    python tests/torch_parallel_worker.py <init_method> <rank> <world> <dir>

reads ``<dir>/inputs.pt`` (configs, weights and batches the test wrote),
runs every scenario below on its meshes, writes ``<dir>/rank<r>.pt`` with
what it saw and prints ``WORKER OK <rank>`` last. Whole tensors gathered
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


def main():
    init_method, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from trlx_tpu_torch.parallel import initialize_runtime

    initialize_runtime(init_method, world, rank, "cpu")
    import torch.distributed as dist

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    out = {
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
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER OK {rank}", flush=True)


if __name__ == "__main__":
    main()
