"""The containment clock (trlx_tpu.supervisor.monotonic's counterpart).

Serve-path timestamps stamped by different threads (HTTP edge,
scheduler worker) are all taken from this one clock, so arithmetic
across them is sound. The watchdog/seam machinery of trlx_tpu's
supervisor is not ported in this slice.
"""

from time import monotonic as _monotonic

monotonic = _monotonic
