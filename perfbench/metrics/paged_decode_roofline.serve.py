"""The traced decode steps' paged-decode calls, at the contexts each step
held: their least time over the paged-decode kernel's device time, per
cent."""

from perfbench import readers


def read(r):
    return readers.paged_roofline(r)
