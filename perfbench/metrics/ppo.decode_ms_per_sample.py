"""Device time of the traced PPO cycle's ``rollout/decode`` phases (each
rollout chunk's graph replays and early-exit reads) over the samples
they covered, ms."""

from perfbench import program_spans


def read(r):
    return program_spans.device_ms_per_row(r, "rollout/decode")
