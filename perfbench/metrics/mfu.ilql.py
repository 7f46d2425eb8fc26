"""Model FLOPs of the traced ILQL updates (real tokens) over their time at
the bf16 peak, per cent."""

from perfbench import readers


def read(r):
    return readers.mfu(r)
