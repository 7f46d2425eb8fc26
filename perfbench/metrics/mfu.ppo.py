"""Model FLOPs a traced PPO cycle needs (rollout, scoring, reward model,
the trainable branch's passes) over its time at the bf16 peak, per cent."""

from perfbench import readers


def read(r):
    return readers.mfu(r)
