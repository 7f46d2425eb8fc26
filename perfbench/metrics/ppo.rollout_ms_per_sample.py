"""Time of make_experience (generation, scoring, reward model, to the
results on the host) per sample, ms."""

from perfbench import readers


def read(r):
    return readers.span_ms_per_sample(r, "ppo.rollout", "rollout_samples")
