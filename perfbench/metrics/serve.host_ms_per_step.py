"""Median over the traced part's scheduler turns that ran a decode step of
the turn's host time: ``serve/iteration`` minus its ``serve/slot_step``,
ms."""

from perfbench import program_spans


def read(r):
    return program_spans.median_self_ms(r, "serve/iteration",
                                        "serve/slot_step")
