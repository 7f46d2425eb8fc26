"""The serve mesh's host channel and follower loop.

trlx_tpu has no such module: JAX drives every device of the serve mesh
from one controller process, so its scheduler's calls reach every chip
through pjit. The port runs one process per card (torchrun), so process
0 runs the whole host side — the scheduler, the radix cache and the
allocator, the HTTP server, speculation's n-gram index — and every other
process runs :func:`follow`: it receives each device call in the order
process 0 makes it and runs the same call on its own shards, until
``stop`` ends the loop. Which calls depends on ``serve.scheduler``:

- ``slots``: those of :class:`~trlx_tpu_torch.serve.slots.SlotPoolRuntime`
  — ``prefill`` for each admission bucket and variant, ``step``,
  ``verify``, ``reset_lanes``, a hot-swap's ``install`` and ``end_swap``,
  and the draft tier's ``draft``;
- ``static``: those of the :class:`~trlx_tpu_torch.serve.engine.
  InferenceEngine` itself — ``decode`` for each bucket-shaped batch the
  micro-batcher flushes (warmup's and a swap's probe included), and a
  hot-swap's ``install`` and ``end_swap``.

:class:`HostChannel` carries the calls: process 0 broadcasts each one's
op name and host arguments (numpy arrays, ints, a checkpoint path) over
a gloo group beside the device group, so a follower waits on the CPU,
not inside a CUDA stream, and an idle server costs nothing. Every
process thus runs every collective of the decode in the same order (the
scheduler's worker thread makes the calls one at a time), and all of
them hold bit-identical logits (after the tp sums and the vocabulary
gather) and seed their generators alike, so they sample the same tokens,
end a static ``generate`` at the same step and never drift apart. Each
process keeps a digest of the tokens it produced
(:attr:`SlotPoolRuntime.digest`, :attr:`InferenceEngine.digest`), which
the tests hold equal across processes.
"""

import contextlib
import threading
# lint: disable=serve-clock -- the gloo group's timeout, not a clock read
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
        #: one message at a time (the serve watchdog's abort closes the
        #: channel from its own thread), and none after ``stop``
        self._lock = threading.Lock()
        self.closed = False  # guarded-by: _lock

    @property
    def leader(self) -> bool:
        """Whether this process runs the host side (process 0)."""
        return self.rank == 0

    def send(self, op: str, *args) -> None:
        """Process 0: publish one call to every follower. After
        :meth:`close` the followers are gone, so a device call would wait
        for them forever: it raises instead."""
        if self.group is None:
            return
        with self._lock:
            if self.closed:
                raise RuntimeError(
                    f"serve mesh: '{op}' after the followers were stopped")
            self._broadcast(op, args)

    def close(self) -> None:
        """Process 0: send ``stop``, which ends every follower's loop (the
        first call only)."""
        if self.group is None:
            return
        with self._lock:
            if not self.closed:
                self.closed = True
                self._broadcast("stop", ())

    def _broadcast(self, op: str, args) -> None:  # holds: _lock
        import torch.distributed as dist

        dist.broadcast_object_list([(op, args)], src=0, group=self.group)

    def recv(self) -> Tuple[str, Tuple[Any, ...]]:
        """A follower: the next call from process 0 (blocks on the CPU)."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def follow(target, draft=None, run_supervisor=None) -> int:
    """A follower's serving loop: run each call process 0 makes on this
    process's shards until ``stop``; returns 0 then. ``target`` is what
    receives the calls: the follower's ``SlotPoolRuntime`` under
    ``scheduler: slots``, its ``InferenceEngine`` under ``static``. Each
    call runs as the ``serve_decode`` phase of ``run_supervisor`` (the
    serve watchdog, armed on every process by ``serve.stall_timeout``),
    whose heartbeat it beats; the wait for the next call is no phase, so
    an idle server never stalls. ``draft`` is the follower's half of the
    draft tier (trlx_tpu_torch.serve.speculate ``DraftProposer``)."""
    channel = getattr(target, "engine", target).channel
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
                    getattr(target, op)(*args)
            supervisor.beat()


def serve_follower(engine) -> int:
    """A follower process of ``python -m trlx_tpu_torch.serve --mesh``:
    the target ``serve.scheduler`` names (the engine itself for
    ``static``; for ``slots`` the runtime and the draft tier, built in
    the order process 0's server builds its own), the serve watchdog
    armed as there, then :func:`follow`."""
    from trlx_tpu_torch.supervisor import RunSupervisor

    cfg = engine.serve
    target, draft = engine, None
    if cfg.scheduler == "static":
        engine.check_graph_transport()
    else:
        from trlx_tpu_torch.serve.slots import SlotPoolRuntime

        target = SlotPoolRuntime(engine)
        if cfg.speculation == "draft" and cfg.spec_draft_checkpoint:
            from trlx_tpu_torch.serve.speculate import DraftProposer

            draft = DraftProposer.from_checkpoint(
                cfg.spec_draft_checkpoint, engine, target.spec_k)
    sup = RunSupervisor(stall_timeout=cfg.stall_timeout,
                        stall_action="abort") \
        if cfg.stall_timeout > 0 else None
    return follow(target, draft, sup)
