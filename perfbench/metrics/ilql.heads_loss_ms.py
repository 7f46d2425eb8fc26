"""Median device time of the heads and the loss of an ILQL update (the
trainer's own CUDA events), ms."""

from perfbench import readers


def read(r):
    return readers.median_part_ms(r, 1)
