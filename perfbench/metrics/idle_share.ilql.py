"""Per cent of a traced run of ILQL updates in which the card ran nothing."""

from perfbench import readers


def read(r):
    return readers.idle_share(r)
