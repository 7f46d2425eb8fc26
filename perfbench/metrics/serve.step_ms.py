"""Median of the scheduler's own decode-step span (time/serve/slot_step),
ms."""


def read(r):
    return r.data.get("step_ms")
