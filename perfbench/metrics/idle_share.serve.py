"""Per cent of a traced part of the serving window in which the card ran
nothing."""

from perfbench import readers


def read(r):
    return readers.idle_share(r)
