"""The traced ILQL updates' flash calls: their least time over the flash
kernels' device time, per cent."""

from perfbench import readers


def read(r):
    return readers.flash_roofline(r)
