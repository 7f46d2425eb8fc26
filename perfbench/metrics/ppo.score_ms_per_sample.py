"""Device time of the traced PPO cycle's ``rollout/score`` phases (each
rollout chunk's shared-trunk forward, both heads' logprobs, the values
and the KL) over the samples they covered, ms."""

from perfbench import program_spans


def read(r):
    return program_spans.device_ms_per_row(r, "rollout/score")
