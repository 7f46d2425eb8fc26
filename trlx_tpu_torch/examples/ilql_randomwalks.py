"""Offline ILQL on the random-walks graph task with the port, as
examples/ilql_randomwalks.py runs it: configs/ilql_config.yml's settings
with that example's overrides (gen_size 10, 10 epochs, batch 64, a
4-layer 144-wide float32 model over the graph's nodes), the graph's
[V, V] edge mask on sampling, the percent-of-optimal-path metric.

    python -m trlx_tpu_torch.examples.ilql_randomwalks [--device cpu]
        [--epochs N] [--checkpoint-dir DIR --checkpoint-interval K
        --keep-checkpoints N --resume-from auto]

Without ``--device cpu`` it runs on the card and raises when there is
none. With the checkpoint flags it is a durable run: it saves
``step_<N>`` checkpoints every K updates, keeps the newest N, and a
relaunch with ``--resume-from auto`` continues from the newest one (the
first line printed, ``start_iter``, is the update it starts from).
"""

import argparse

import numpy as np

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.examples.ilql_sentiments import ilql_config
from trlx_tpu_torch.examples.randomwalks_data import generate_random_walks
from trlx_tpu_torch.utils.loading import get_model, get_orchestrator


def randomwalks_config(n_nodes: int, epochs: int = 10,
                       **train) -> TRLConfig:
    """The example's config; ``train`` overrides train-section keys
    (the checkpoint knobs)."""
    config = ilql_config()
    config["model"].update(
        tokenizer_path="byte", compute_dtype="float32",
        model_spec={"vocab_size": n_nodes, "n_layer": 4, "n_head": 4,
                    "d_model": 144, "n_positions": 16})
    config["train"].update(gen_size=10, epochs=epochs, batch_size=64,
                           eval_interval=50, log_interval=25,
                           checkpoint_interval=10**9)
    config["train"].update(train)
    return TRLConfig.from_dict(config)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-interval", type=int, default=None)
    ap.add_argument("--keep-checkpoints", type=int, default=None)
    ap.add_argument("--resume-from", default=None,
                    help="a checkpoint or run dir, or 'auto'")
    args = ap.parse_args(argv)
    walks, logit_mask, stats_fn, reward_fn = generate_random_walks(
        seed=args.seed)
    train = {key: value for key, value in (
        ("checkpoint_dir", args.checkpoint_dir),
        ("checkpoint_interval", args.checkpoint_interval),
        ("keep_checkpoints", args.keep_checkpoints),
        ("resume_from", args.resume_from)) if value is not None}
    config = randomwalks_config(int(logit_mask.shape[0]), args.epochs,
                                **train)
    eval_prompts = np.arange(1, logit_mask.shape[0]).reshape(-1, 1)
    trainer = get_model(config.model.model_type)(
        config, logit_mask=logit_mask, device=args.device)
    print({"start_iter": trainer.iter_count}, flush=True)
    get_orchestrator(config.train.orchestrator)(
        trainer, walks, eval_prompts, reward_fn=reward_fn, stats_fn=stats_fn)
    print({"walk_baseline": stats_fn(walks)}, flush=True)
    before = trainer.evaluate()
    print({"before": before}, flush=True)
    trainer.learn(log_fn=lambda stats: print(stats, flush=True))
    after = trainer.evaluate()
    print({"after": after}, flush=True)
    return trainer, before, after


if __name__ == "__main__":
    main()
