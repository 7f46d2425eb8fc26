"""Per cent of a traced PPO cycle in which the card ran nothing."""

from perfbench import readers


def read(r):
    return readers.idle_share(r)
