"""Model FLOPs of the traced serving steps (each prompt token and served
token once) over their time at the bf16 peak, per cent."""

from perfbench import readers


def read(r):
    return readers.mfu(r)
