"""Neighbour exchange along one mesh axis: the one point-to-point
pattern that ring attention (trlx_tpu_torch.ops.ring_attention) and the
GPipe schedule (trlx_tpu_torch.ops.pipeline_parallel) are written
against, in place of trlx_tpu's ``jax.lax.ppermute``.

An exchange serves the ranks of a group of ``n`` that live in this
process (:attr:`ranks`) and moves tensors one hop up the group: rank r
hands its tensors to rank r + 1 (mod n on a ring, none past the last
rank on a pipeline). Both implementations run the same caller code:

- :class:`P2PExchange`, one rank per process: ``batch_isend_irecv`` on
  the axis's process group (NCCL on the card, gloo on the CPU), peers
  named by global rank, the send and the receive of one hop in one
  batch, posted in the same order on every rank. A pipeline's first
  and last ticks leave some ranks with nothing to post, and
  ``batch_isend_irecv`` must not be a group's first collective unless
  every rank of the group joins it (NCCL starts a group's communicator
  lazily, on its first collective). So the first exchange built on each
  group runs one all-reduce that every rank of the group joins;
- :class:`LoopbackExchange`, every rank of the group in this process:
  rank r's tensors are handed to rank r + 1 directly. It serves the CPU
  tests and the chip smoke, which run a whole group's work on one
  device; no entry point chooses it by itself.
"""

from typing import List, Optional, Sequence

import torch

Tensors = Optional[Sequence[torch.Tensor]]


class LoopbackExchange:
    """All ``n`` ranks of a group in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a group has at least one rank, got {n}")
        self.n = n
        self.ranks = list(range(n))

    def shift(self, sends: List[Tensors], recv_like: List[Tensors],
              wrap: bool = True) -> List[Tensors]:
        """``sends[i]``: what local rank ``ranks[i]`` hands up the group
        (None: nothing); ``recv_like[i]``: templates of what it takes from
        the rank below (None: nothing). Returns what each local rank
        received."""
        out = []
        for i, r in enumerate(self.ranks):
            if recv_like[i] is None:
                out.append(None)
                continue
            src = (r - 1) % self.n if wrap else r - 1
            got = sends[src] if src >= 0 else None
            if got is None:
                raise ValueError(f"rank {r} expects a hop from rank {src}, "
                                 f"which sends nothing")
            out.append(list(got))
        return out

    def broadcast(self, values: List[Tensors], src: int) -> List[Tensors]:
        """Rank ``src``'s tensors, for every local rank."""
        return [list(values[src]) for _ in self.ranks]


#: process groups whose ranks have all joined one collective
_STARTED: List = []


class P2PExchange:
    """This process's rank of one mesh axis's process group. Every rank
    of the group builds its exchange at the same point of the program."""

    def __init__(self, mesh, axis: str):
        from trlx_tpu_torch.parallel.mesh import axis_group

        self.group, rank, self.n, self.global_ranks = axis_group(mesh, axis)
        self.ranks = [rank]
        self.rank = rank
        if not any(g is self.group for g in _STARTED):
            self._start()

    def _start(self) -> None:
        """One all-reduce over the group, joined by every rank, before
        its first point-to-point batch."""
        import torch.distributed as dist

        device = "cpu"
        if dist.get_backend(self.group) == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        dist.all_reduce(torch.zeros(1, device=device), group=self.group)
        _STARTED.append(self.group)

    def shift(self, sends: List[Tensors], recv_like: List[Tensors],
              wrap: bool = True) -> List[Tensors]:
        import torch.distributed as dist

        r, n = self.rank, self.n
        ops, bufs = [], None
        if recv_like[0] is not None:
            src = self.global_ranks[(r - 1) % n]
            bufs = [torch.empty_like(t) for t in recv_like[0]]
            ops += [dist.P2POp(dist.irecv, b, src, self.group) for b in bufs]
        if sends[0] is not None:
            dst = self.global_ranks[(r + 1) % n]
            ops += [dist.P2POp(dist.isend, t.contiguous(), dst, self.group)
                    for t in sends[0]]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [bufs]

    def broadcast(self, values: List[Tensors], src: int) -> List[Tensors]:
        import torch.distributed as dist

        out = [t.contiguous() if self.rank == src else t.clone()
               for t in values[0]]
        for t in out:
            dist.broadcast(t, self.global_ranks[src], group=self.group)
        return [out]
