"""PPO TL;DR summarization with a learned reward model on the trainer's
device, with the port: the offline fallback of examples/ppo_tldr.py.

The reward model is a trunk plus a scalar head (trlx_tpu_torch.models.
reward) built from the trainer's OWN trunk with a fresh head; the PPO
orchestrator scores each rollout chunk with it on the device, with no
decode and no host reward call. The prompts are synthetic documents
ending in the TL;DR cue; the policy is the fallback's tiny from-config
model with the byte tokenizer (the online pieces, a pretrained gpt2 and
its tokenizer, wait for the pretrained import). The config is
configs/ppo_tldr.yml's, from a dict (:func:`tldr_config`).

    python -m trlx_tpu_torch.examples.ppo_tldr [--device cpu]
        [--total-steps N]

Without ``--device cpu`` it runs on the card and raises when there is
none.
"""

import argparse

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.policy import all_blocks
from trlx_tpu_torch.models.reward import DeviceRewardModel, RewardModel
from trlx_tpu_torch.utils.loading import (
    get_model,
    get_orchestrator,
    get_pipeline,
)


def tldr_config() -> dict:
    """configs/ppo_tldr.yml as a dict (the card machine has no pyyaml)."""
    return {
        "model": {
            "model_path": "gpt2", "tokenizer_path": "gpt2",
            "model_type": "JaxPPOTrainer", "num_layers_unfrozen": 2,
            "compute_dtype": "bfloat16",
        },
        "train": {
            "n_ctx": 1024, "epochs": 20, "total_steps": 80000,
            "batch_size": 32, "grad_clip": 1.0, "lr_ramp_steps": 100,
            "lr_decay_steps": 79000, "weight_decay": 1.0e-6,
            "learning_rate_init": 1.412e-4,
            "learning_rate_target": 1.412e-4, "log_interval": 25,
            "checkpoint_interval": 100000, "eval_interval": 100,
            "input_size": 512, "gen_size": 64, "pipeline": "PPOPipeline",
            "orchestrator": "PPOOrchestrator", "seed": 0,
            "mesh": {"dp": -1, "fsdp": 1, "tp": 1},
        },
        "method": {
            "name": "ppoconfig", "num_rollouts": 64, "chunk_size": 32,
            "ppo_epochs": 4, "init_kl_coef": 0.2, "target": 6,
            "horizon": 10000, "gamma": 1, "lam": 0.95, "cliprange": 0.2,
            "cliprange_value": 0.2, "vf_coef": 0.2,
            "gen_kwargs": {"max_length": 64, "min_length": 48, "top_k": 0,
                           "top_p": 1.0, "do_sample": True,
                           "temperature": 0.7},
        },
    }


def offline_config(total_steps: int = 80000) -> TRLConfig:
    """:func:`tldr_config` with examples/ppo_tldr.py's offline overrides:
    a tiny from-config model, the byte tokenizer, fp32, short documents
    and summaries, small rollouts."""
    cfg = tldr_config()
    cfg["model"].update(
        model_path="from-config", tokenizer_path="byte",
        compute_dtype="float32",
        model_spec={"vocab_size": 257, "n_layer": 4, "n_head": 8,
                    "d_model": 256, "n_positions": 128})
    cfg["train"].update(input_size=48, gen_size=16, epochs=4, batch_size=16,
                        log_interval=4, eval_interval=10**9,
                        checkpoint_interval=10**9, total_steps=total_steps)
    cfg["method"].update(num_rollouts=32, chunk_size=16,
                         gen_kwargs={"max_length": 16, "min_length": 16,
                                     "do_sample": True})
    return TRLConfig.from_dict(cfg)


def synthetic_documents(n: int = 256, seed: int = 0):
    """Deterministic document-like prompts ending in the TL;DR cue."""
    rng = np.random.default_rng(seed)
    words = ["data", "model", "train", "loss", "token", "batch", "step",
             "eval", "mesh", "chip"]
    return [" ".join(rng.choice(words, size=30)) + "\nTL;DR:"
            for _ in range(n)]


def build_reward_model(config, trainer, head_seed: int = 1):
    """A reward model from the trainer's own trunk (the embeddings, the
    frozen bottom and trainable top blocks, the final norm) with a fresh
    scalar head, on the trainer's device; DeviceRewardModel copies the
    tensors, so the trainer's updates do not reach it."""
    model = RewardModel(spec=trainer.policy.spec,
                        compute_dtype=trainer.policy.compute_dtype)
    p = trainer.params
    params = model.from_trunk(p["frozen_base"]["embed"],
                              all_blocks(p),
                              p["trainable"]["ln_f"], head_seed=head_seed)
    return DeviceRewardModel(
        model, params, trainer.tokenizer, device=trainer.device,
        max_length=config.train.input_size + config.train.gen_size,
        mesh=trainer.mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--total-steps", type=int, default=80000)
    args = ap.parse_args(argv)
    config = offline_config(args.total_steps)
    trainer = get_model(config.model.model_type)(config, device=args.device)
    reward_model = build_reward_model(config, trainer)
    pipeline = get_pipeline(config.train.pipeline)(
        synthetic_documents(), trainer.tokenizer, config)
    orch = get_orchestrator(config.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_model,
        chunk_size=config.method.chunk_size)
    logs = []

    def log(stats):
        logs.append(stats)
        print({k: v for k, v in stats.items()
               if k not in ("samples", "generations_table")}, flush=True)

    log({"first_rollout": orch.make_experience(config.method.num_rollouts)})
    trainer.learn(log_fn=log)
    log({"final_eval": trainer.evaluate()})
    return trainer, logs


if __name__ == "__main__":
    main()
