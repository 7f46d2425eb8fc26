"""PPO on the offline synthetic task of examples/ppo_sentiments.py, with
the port: registry-built trainer, prompt pipeline, orchestrator and
learn loop, on a from-config tiny model (seeded random weights), the
byte tokenizer and a lowercase-ratio reward. The online pieces (an HF
policy, IMDB prompts, a sentiment reward) wait for the pretrained
import.

    python -m trlx_tpu_torch.examples.ppo_sentiments [--device cpu]
        [--total-steps N] [--mesh '{"dp": -1, "fsdp": 2, "tp": 2}']

Without ``--device cpu`` it runs on the card and raises when there is
none. On several cards, one process each:

    torchrun --nproc_per_node N -m trlx_tpu_torch.examples.ppo_sentiments \
        --mesh '{"dp": -1, "fsdp": 2, "tp": 2}'

(``train.mesh``; without ``--mesh`` every process goes to dp). Only the
main process prints.
"""

import argparse
import json

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.parallel import is_main_process
from trlx_tpu_torch.utils.loading import get_model, get_orchestrator, get_pipeline


def offline_config(total_steps: int = 200) -> TRLConfig:
    """configs/ppo_config.yml's PPO settings with the offline fallback's
    tiny model (examples/ppo_sentiments.py ``offline_pieces``)."""
    return TRLConfig.from_dict({
        "model": {
            "model_path": "from-config", "tokenizer_path": "byte",
            "model_type": "JaxPPOTrainer", "num_layers_unfrozen": 2,
            "model_spec": {"vocab_size": 257, "n_layer": 4, "n_head": 8,
                           "d_model": 256, "n_positions": 128},
            "compute_dtype": "float32",
        },
        "train": {
            "n_ctx": 512, "epochs": 6, "total_steps": total_steps,
            "batch_size": 64, "grad_clip": 1.0, "lr_ramp_steps": 100,
            "lr_decay_steps": 79000, "weight_decay": 1e-6,
            "learning_rate_init": 2e-3, "learning_rate_target": 1e-3,
            "log_interval": 4, "checkpoint_interval": 10**9,
            "eval_interval": 16, "pipeline": "PPOPipeline",
            "orchestrator": "PPOOrchestrator", "input_size": 4,
            "gen_size": 48, "seed": 0,
        },
        "method": {
            "name": "ppoconfig", "num_rollouts": 64, "chunk_size": 64,
            "ppo_epochs": 4, "init_kl_coef": 0.2, "target": 6,
            "horizon": 10000, "gamma": 1, "lam": 0.95, "cliprange": 0.2,
            "cliprange_value": 0.2, "vf_coef": 2.3,
            "gen_kwargs": {"max_length": 48, "min_length": 48, "top_k": 0,
                           "top_p": 1.0, "do_sample": True},
        },
    })


def reward_fn(samples):
    """Fraction of lowercase characters in each sample."""
    return [float(np.mean([c.islower() for c in s] or [0.0]))
            for s in samples]


def prompts(n: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    return ["".join(chr(c) for c in rng.integers(32, 127, size=12))
            for _ in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--total-steps", type=int, default=200)
    ap.add_argument("--mesh", type=json.loads, default=None,
                    help="train.mesh as JSON, e.g. '{\"fsdp\": 2, "
                         "\"tp\": 2}'")
    args = ap.parse_args(argv)
    config = offline_config(args.total_steps)
    config.train.mesh = args.mesh
    trainer = get_model(config.model.model_type)(config, device=args.device)
    pipeline = get_pipeline(config.train.pipeline)(
        prompts(), trainer.tokenizer, config)
    orch = get_orchestrator(config.train.orchestrator)(
        trainer, pipeline, reward_fn=reward_fn,
        chunk_size=config.method.chunk_size)
    logs = []

    def log(stats):
        logs.append(stats)
        if is_main_process():
            print({k: v for k, v in stats.items() if k != "samples"},
                  flush=True)

    log({"rollout": orch.make_experience(config.method.num_rollouts)})
    trainer.learn(log_fn=log)
    return trainer, logs


if __name__ == "__main__":
    main()
