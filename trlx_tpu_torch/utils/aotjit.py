"""A cache of CUDA graphs keyed by argument signature: the port's
counterpart of ``trlx_tpu.utils.aotjit``.

``aot_jit(fn)`` returns a callable with the JAX wrapper's cache
semantics. A call's signature is the argument tree's structure plus,
for each tensor leaf, its shape, dtype and device, and for every other
leaf its value (a ``torch.Generator`` or a function keys by identity).
When the arguments' tensors lie on the card, the first call of a
signature runs ``fn`` eagerly on a side stream (its result is the
call's result, and any lazy set-up happens there), then captures one
``torch.cuda.CUDAGraph`` of ``fn`` over the same arguments; every later
call of that signature replays the graph. A miss once the cache holds an
entry increments ``compile/recompiles``, as the JAX wrapper does: an
argument that drifts every call shows as a counter climbing with the
calls, not as silence. CPU arguments run ``fn`` directly, keyed and
counted alike, so the CPU tests run the code the card captures.

The graph's contract, which ``fn`` must keep (a capture that breaks it
raises; nothing falls back to eager):

- static shapes: every shape inside ``fn`` follows from the signature;
- no host syncs: no ``.item()``, ``bool(t)``, ``nonzero``, boolean-mask
  indexing or ``torch.multinomial`` (whose input check reads back);
- no host-to-device copies from pageable memory: make the device
  tensors before the call;
- no allocation that outlives the graph's pool except its outputs:
  ``fn`` stores no tensor it allocates anywhere but its return value
  or the in-place updates of its arguments;
- random draws only through a ``torch.Generator`` passed as an
  argument. It is registered with the graph, so each replay draws from
  the generator's seed and offset at replay time (a ``manual_seed``
  just before is seen) and advances the offset as the eager call would.

The first call's tensors become the graph's inputs: the entry keeps
them and every replay reads their memory. A later call whose tensor
lies elsewhere (another storage, offset or stride) has it copied into
that first tensor before the replay. So weights and state updated in
place are read as they are, with no copy, and a rebuilt tensor costs
one copy. Pass no tensor that the caller reads again after a later
call of the same signature with another tensor in its place.

A replay returns the graph's own output tensors: they stay valid only
until the next call of the same signature.

Captures run in ``thread_local`` mode, so other threads may launch,
allocate and read back on their own streams meanwhile (a reward seam
abandoned by ``bounded_call`` that still scores on the card, say). A
device-wide ``torch.cuda.synchronize()`` from another thread during a
capture is what CUDA forbids: it invalidates the capture. Such a capture
is taken again, up to :data:`CAPTURE_ATTEMPTS` times, each retry
counted in ``compile/capture_retries``; any other capture error raises.
Python's cycle collector is paused while a capture runs
(:func:`collector_paused`): a collection there could free a dead
reference cycle that holds another CUDA graph (an engine dropped
earlier), and CUDA refuses to destroy a graph on a capturing thread.

On a device mesh the signature of a DTensor leaf also holds its
placements and its mesh, and a card call with a DTensor argument raises
instead of capturing: a DTensor op may run a collective that its peers
do not, so the training mesh's decode step takes whole plain parameters
and the process's own rows, and runs no collective.

A ``fn`` whose collectives every process of its group runs in the same
order may hold them (the serve mesh's step: trlx_tpu_torch.serve.slots,
whose process 0 mirrors every call to the others). Over NCCL they are
captured into the graph like any launch: the eager first call runs each
communicator's first collective before the capture, the capture takes
them on its own stream, and each replay launches them again on every
process. A gloo collective cannot be captured (it stages CUDA tensors
through the host): the serve runtime refuses graphs over gloo at
construction, with a message, instead of replaying eager in silence.

The module switch :data:`CUDA_GRAPHS` set to False runs ``fn`` eagerly
on the card too (still keyed and counted): the A/B of
``chip_smoke.py``. Nothing else selects the eager path.
"""

import contextlib
import gc
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from trlx_tpu_torch import ops, telemetry
from trlx_tpu_torch.supervisor import monotonic

__all__ = ["aot_jit", "CUDA_GRAPHS", "collector_paused", "tree_flatten"]

#: capture and replay CUDA graphs for card arguments (chip_smoke A/Bs it)
CUDA_GRAPHS = True

#: captures of one signature before an invalidated capture raises
CAPTURE_ATTEMPTS = 3

#: the counters a capture may bump, predeclared at the first capture
CAPTURE_COUNTERS = ("compile/capture_retries",)


_PAUSED, _WAS_ENABLED = 0, True
_PAUSED_LOCK = threading.Lock()


@contextlib.contextmanager
def collector_paused():
    """Python's cycle collector off for the block, for captures on any
    number of threads at once: the last to leave turns it back on if it
    was on. Garbage made meanwhile is collected after."""
    global _PAUSED, _WAS_ENABLED
    with _PAUSED_LOCK:
        if _PAUSED == 0:
            _WAS_ENABLED = gc.isenabled()
            gc.disable()
        _PAUSED += 1
    try:
        yield
    finally:
        with _PAUSED_LOCK:
            _PAUSED -= 1
            if _PAUSED == 0 and _WAS_ENABLED:
                gc.enable()


def _capture_invalidated(err: BaseException) -> bool:
    """Whether a capture failed because CUDA invalidated it (another
    thread synchronised the device while it ran)."""
    return "cudaErrorStreamCaptureInvalidated" in str(err)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) of nested dicts (keys sorted, as JAX's
    treedef sorts them), lists, tuples and named tuples; ``None`` is an
    empty node, everything else a leaf."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return (dict, keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            return (type(x), len(x), tuple(walk(v) for v in x))
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _leaf_sig(x):
    if _is_dtensor(x):
        # placements and mesh shape what each op does, and which
        # collectives it runs
        mesh = x.device_mesh
        return (tuple(x.shape), str(x.dtype), str(x.device),
                tuple(map(str, x.placements)), mesh.mesh_dim_names,
                tuple(mesh.mesh.flatten().tolist()))
    if torch.is_tensor(x):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    # a plain leaf's VALUE shapes what fn does, so it keys the cache
    try:
        hash(x)
        return ("py", type(x), x)
    except TypeError:
        return ("py", type(x), repr(x))


class _Graph:
    """One captured signature: the graph, the tensors it reads, its
    outputs, the kernel launches its capture recorded, and the capture's
    cost."""

    def __init__(self, graph, inputs, outputs, launches, seconds, pool_bytes):
        self.graph = graph
        self.inputs = inputs  # per leaf: the captured tensor, or None
        self.outputs = outputs
        self.launches = launches
        self.seconds = seconds
        self.pool_bytes = pool_bytes

    def replay(self, leaves):
        for held, x in zip(self.inputs, leaves):
            if held is not None and x is not held and (
                    x.data_ptr() != held.data_ptr()
                    or x.stride() != held.stride()):
                held.copy_(x)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.outputs


def _card_device(leaves) -> Optional[torch.device]:
    for x in leaves:
        if torch.is_tensor(x) and x.device.type == "cuda":
            return x.device
    return None


class _AotJit:
    def __init__(self, fn):
        self._fn = fn
        #: signature -> its captured graph (None until one is captured)
        self._cache: Dict[Any, Optional[_Graph]] = {}

    def __call__(self, *args):
        leaves, treedef = tree_flatten(args)
        key = (treedef, tuple(_leaf_sig(x) for x in leaves))
        if key not in self._cache:
            if self._cache:
                # steady-state miss: an entry exists but this signature
                # matches none (trlx_tpu.utils.aotjit's counter)
                telemetry.inc("compile/recompiles")
            self._cache[key] = None
        device = _card_device(leaves)
        if device is None or not CUDA_GRAPHS:
            return self._fn(*args)
        if any(_is_dtensor(x) for x in leaves):
            # a DTensor op may run a collective its peers do not run
            raise ValueError(
                "aot_jit captures no DTensor argument: pass each "
                "process's local tensors (the mesh's decode path hands "
                "the step whole plain parameters and its own rows)")
        entry = self._cache[key]
        if entry is None:
            entry, out = self._capture(args, leaves, device)
            self._cache[key] = entry
            return out
        return entry.replay(leaves)

    def _capture(self, args, leaves, device):
        """The first call: ``fn`` eagerly on a side stream (the result),
        then one capture over the same arguments, taken again when CUDA
        invalidated it (module docstring)."""
        # a capture is where a retry can happen: from the first one on,
        # the counter reads 0 until one does
        telemetry.predeclare(CAPTURE_COUNTERS)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._fn(*args)
        current.wait_stream(side)
        for attempt in range(1, CAPTURE_ATTEMPTS + 1):
            try:
                return self._capture_once(args, leaves, device), out
            except Exception as e:
                if attempt == CAPTURE_ATTEMPTS or not _capture_invalidated(e):
                    raise
                telemetry.inc("compile/capture_retries")

    def _capture_once(self, args, leaves, device) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        for x in leaves:
            if isinstance(x, torch.Generator):
                graph.register_generator_state(x)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # what the graph's pool reserves shows
        reserved = torch.cuda.memory_reserved(device)
        start = monotonic()
        with ops.recording_launches() as launches, collector_paused():
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self._fn(*args)
        torch.cuda.synchronize(device)
        seconds = monotonic() - start
        inputs = [x if torch.is_tensor(x) else None for x in leaves]
        return _Graph(graph, inputs, outputs, launches, seconds,
                      torch.cuda.memory_reserved(device) - reserved)

    def graphs(self) -> List[_Graph]:
        """The captured entries (capture seconds, pool bytes)."""
        return [e for e in self._cache.values() if e is not None]

    def signatures(self) -> int:
        return len(self._cache)


def aot_jit(fn):
    """``fn`` behind a per-signature cache of CUDA graphs (module
    docstring). Positional arguments only, as the JAX wrapper."""
    return _AotJit(fn)
