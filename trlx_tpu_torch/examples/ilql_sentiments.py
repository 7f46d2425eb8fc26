"""Offline ILQL sentiment tuning with the port: the offline fallback of
examples/ilql_sentiments.py — configs/ilql_config.yml's settings on a
from-config tiny model (seeded random weights), the byte tokenizer, a
synthetic labeled corpus (sentences ending in "good" or "bad") and a
lexicon reward, through the registry, the offline orchestrator and
learn(). The online pieces (an HF trunk, IMDB, a distilbert reward) wait
for the pretrained import.

    python -m trlx_tpu_torch.examples.ilql_sentiments [--device cpu]
        [--epochs N]

Without ``--device cpu`` it runs on the card and raises when there is
none.
"""

import argparse

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.utils.loading import get_model, get_orchestrator


def ilql_config() -> dict:
    """configs/ilql_config.yml as a dict (the card machine has no
    pyyaml): gpt2-124M trunk at full unfreeze, bf16, batch 80, n_ctx 512,
    gen_size 32, tau 0.7, gamma 0.99, cql 0.1, awac 1, alpha 1, beta 4,
    two Q heads, a target sync every 10 steps."""
    return {
        "model": {
            "model_path": "gpt2", "tokenizer_path": "gpt2",
            "model_type": "JaxILQLTrainer", "num_layers_unfrozen": -1,
            "compute_dtype": "bfloat16",
        },
        "train": {
            "n_ctx": 512, "epochs": 1, "total_steps": 80000,
            "batch_size": 80, "grad_clip": 1.0, "lr_ramp_steps": 100,
            "lr_decay_steps": 3366, "weight_decay": 1.0e-6,
            "learning_rate_init": 1.0e-3, "learning_rate_target": 1.0e-3,
            "log_interval": 25, "checkpoint_interval": 100,
            "eval_interval": 50, "input_size": 1, "gen_size": 32,
            "pipeline": "OfflinePipeline",
            "orchestrator": "OfflineOrchestrator", "seed": 0,
            "telemetry": True, "mesh": {"dp": -1, "fsdp": 1, "tp": 1},
        },
        "method": {
            "name": "ilqlconfig", "tau": 0.7, "gamma": 0.99,
            "cql_scale": 0.1, "awac_scale": 1, "alpha": 1,
            "steps_for_target_q_sync": 10, "beta": 4, "two_qs": True,
        },
    }


def offline_config(epochs: int = 8) -> TRLConfig:
    """ilql_config() with examples/ilql_sentiments.py's offline
    fallback: a 4-layer, 256-wide model over the byte vocabulary,
    float32, batch 64, 24 generated tokens."""
    config = ilql_config()
    config["model"].update(
        tokenizer_path="byte", compute_dtype="float32",
        model_spec={"vocab_size": 257, "n_layer": 4, "n_head": 8,
                    "d_model": 256, "n_positions": 64})
    config["train"].update(epochs=epochs, batch_size=64, gen_size=24,
                           eval_interval=50, checkpoint_interval=10**9)
    return TRLConfig.from_dict(config)


POS, NEG = "good", "bad"


def reward_fn(samples):
    """Count of "good" minus count of "bad"; token rows are read as
    bytes."""
    if samples and not isinstance(samples[0], str):
        samples = ["".join(map(chr, (int(t) for t in s if int(t) < 256)))
                   for s in samples]
    return [float(s.count(POS)) - float(s.count(NEG)) for s in samples]


def train_samples(n: int = 2048, seed: int = 0):
    rng = np.random.default_rng(seed)
    fillers = ["the movie was", "i think it is", "overall it felt",
               "honestly it was", "the plot seemed"]
    return [f"{rng.choice(fillers)} {POS if rng.random() < 0.5 else NEG}"
            for _ in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)
    config = offline_config(args.epochs)
    trainer = get_model(config.model.model_type)(config, device=args.device)
    get_orchestrator(config.train.orchestrator)(
        trainer, train_samples(), ["the movie was"] * 32,
        reward_fn=reward_fn)
    before = trainer.evaluate(n=32)
    print({"before": before["reward"]}, flush=True)
    trainer.learn(log_fn=lambda stats: print(
        {k: v for k, v in stats.items() if k != "samples_table"},
        flush=True))
    after = trainer.evaluate(n=32)
    print({"after": after["reward"]}, flush=True)
    return trainer, before, after


if __name__ == "__main__":
    main()
