"""The serve mesh's host channel and follower loop.

trlx_tpu has no such module: JAX drives every device of the serve mesh
from one controller process, so its scheduler's calls reach every chip
through pjit. The port runs one process per card (torchrun), so process
0 runs the whole host side — the slot scheduler, the radix cache and the
allocator, the HTTP server, speculation's n-gram index — and every other
process runs :func:`follow`: it receives each device call of
:class:`~trlx_tpu_torch.serve.slots.SlotPoolRuntime` in the order process
0 makes it and runs the same call on its own shards: ``prefill`` for
each admission bucket and variant, ``step``, ``verify``,
``reset_lanes``, a hot-swap's ``install`` and ``end_swap``, the draft
tier's ``draft``, and ``stop``, which ends the loop.

:class:`HostChannel` carries the calls: process 0 broadcasts each one's
op name and host arguments (numpy arrays, ints, a checkpoint path) over
a gloo group beside the device group, so a follower waits on the CPU,
not inside a CUDA stream, and an idle server costs nothing. Every
process thus runs every collective of the decode step in the same order
(the scheduler's worker thread makes the calls one at a time), and all
of them hold bit-identical logits (after the tp sums and the vocabulary
gather) and seed their generators alike, so they sample the same tokens
and their KV caches never drift apart. Each process keeps a digest of
the tokens its steps produced (:attr:`SlotPoolRuntime.digest`), which
the tests hold equal across processes.
"""

import contextlib
from datetime import timedelta
from typing import Any, Tuple

from trlx_tpu_torch import supervisor

#: how long a follower waits for process 0's next call: an idle server
#: sends none, so the channel waits as long as the server lives; a dead
#: process 0 closes the channel's sockets, which ends the wait at once
_IDLE = timedelta(days=365)

class HostChannel:
    """Process 0 -> every process of the world: ``(op, args)`` messages
    over a gloo group of their own. Built by every process of the world
    at the same point (a group is created collectively); in a world of
    one there is no group and :meth:`send` does nothing."""

    def __init__(self):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = dist.new_group(backend="gloo", timeout=_IDLE) \
            if self.world > 1 else None

    @property
    def leader(self) -> bool:
        """Whether this process runs the host side (process 0)."""
        return self.rank == 0

    def send(self, op: str, *args) -> None:
        """Process 0: publish one call to every follower."""
        if self.group is None:
            return
        import torch.distributed as dist

        dist.broadcast_object_list([(op, args)], src=0, group=self.group)

    def recv(self) -> Tuple[str, Tuple[Any, ...]]:
        """A follower: the next call from process 0 (blocks on the CPU)."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def follow(runtime, draft=None, run_supervisor=None) -> int:
    """A follower's serving loop: run each call process 0 makes on this
    process's shards until ``stop``; returns 0 then. Each call runs as
    the ``serve_decode`` phase of ``run_supervisor`` (the serve watchdog,
    armed on every process by ``serve.stall_timeout``), whose heartbeat
    it beats; the wait for the next call is no phase, so an idle server
    never stalls. ``draft`` is the follower's half of the draft tier
    (trlx_tpu_torch.serve.speculate ``DraftProposer``)."""
    channel = runtime.engine.channel
    if channel is None or channel.leader:
        raise ValueError("follow() runs on the followers of a serve mesh "
                         "(processes 1..N-1)")
    with run_supervisor or contextlib.nullcontext():
        while True:
            op, args = channel.recv()
            if op == "stop":
                return 0
            with supervisor.phase("serve_decode"):
                if op == "draft":
                    draft.run(*args)
                else:
                    getattr(runtime, op)(*args)
            supervisor.beat()


def serve_follower(engine) -> int:
    """A follower process of ``python -m trlx_tpu_torch.serve --mesh``:
    the runtime (and the draft tier) built in the order process 0's
    server builds its own, the serve watchdog armed as there, then
    :func:`follow`."""
    from trlx_tpu_torch.serve.slots import SlotPoolRuntime
    from trlx_tpu_torch.supervisor import RunSupervisor

    cfg = engine.serve
    runtime = SlotPoolRuntime(engine)
    draft = None
    if cfg.speculation == "draft" and cfg.spec_draft_checkpoint:
        from trlx_tpu_torch.serve.speculate import DraftProposer

        draft = DraftProposer.from_checkpoint(
            cfg.spec_draft_checkpoint, engine, runtime.spec_k)
    sup = RunSupervisor(stall_timeout=cfg.stall_timeout,
                        stall_action="abort") \
        if cfg.stall_timeout > 0 else None
    return follow(runtime, draft, sup)
