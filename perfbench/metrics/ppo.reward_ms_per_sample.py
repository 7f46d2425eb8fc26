"""Device time of the traced PPO cycle's ``rollout/reward_model`` phases
(the reward model's scores of each rollout chunk) over the samples they
covered, ms."""

from perfbench import program_spans


def read(r):
    return program_spans.device_ms_per_row(r, "rollout/reward_model")
