"""Per cent of the window's prompt tokens that admission served from the
radix prefix cache."""

from perfbench import readers


def read(r):
    return readers.prefix_hit_rate(r)
