"""Device time of the traced PPO cycle's ``rollout/prefill`` phases (each
rollout chunk's eager prefill into the decoder's buffers) over the
samples they covered, ms."""

from perfbench import program_spans


def read(r):
    return program_spans.device_ms_per_row(r, "rollout/prefill")
