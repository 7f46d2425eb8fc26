"""Time of the update passes per sample of the cycle, ms."""

from perfbench import readers


def read(r):
    return readers.span_ms_per_sample(r, "ppo.update", "update_samples")
