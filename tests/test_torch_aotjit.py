"""The port's CUDA-graph cache (trlx_tpu_torch.utils.aotjit) against
trlx_tpu's AOT executable cache: one call sequence (same shapes, a new
shape, a dtype drift, a plain-leaf change, a tree-structure change, and
back to a known signature) counts ``compile/recompiles`` identically
and gives the same outputs. On the CPU the port's wrapper runs the
function directly and keeps no tensor. The ``cuda`` cases capture a
tiny graph on the card (each decides inside itself whether a card is
there): replay, launch accounting through the paged-decode kernel, a
generator re-seeded before each replay, weights swapped in place or
rebound, and a capture that another thread's device-wide synchronize
invalidated, taken again (on the CPU: the retry policy itself).

The JAX side is imported inside its test, so the card cases run
without JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_aotjit.py"""

import numpy as np
import pytest
import torch

from trlx_tpu_torch import ops, telemetry
from trlx_tpu_torch.utils import aotjit
from trlx_tpu_torch.utils.aotjit import aot_jit, tree_flatten


def _fn(tree, scale):
    return tree["x"] * scale + tree["y"][0]


def _calls():
    """(tree of float32 numpy arrays, plain scale, in bf16?, expected
    recompile count)."""
    rng = np.random.default_rng(0)

    def tree(rows=4, extra=False):
        t = {"x": rng.standard_normal((rows, 3)).astype(np.float32),
             "y": (rng.standard_normal((rows, 3)).astype(np.float32),)}
        if extra:
            t["z"] = rng.standard_normal(2).astype(np.float32)
        return t

    return [
        (tree(), 2.0, False, 0),  # first signature: a compile, not a miss
        (tree(), 2.0, False, 0),  # same shapes, new values: a hit
        (tree(rows=8), 2.0, False, 1),  # a new shape
        (tree(), 2.0, True, 2),  # a dtype drift
        (tree(), 3.0, False, 3),  # a plain leaf's value
        (tree(extra=True), 2.0, False, 4),  # the tree's structure
        (tree(), 2.0, False, 4),  # back to a known signature: a hit
    ]


def _convert(tree, to):
    if isinstance(tree, dict):
        return {k: _convert(v, to) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_convert(v, to) for v in tree)
    return to(tree)


def test_recompile_counts_and_outputs_match_trlx_tpu():
    import jax.numpy as jnp

    from trlx_tpu import telemetry as jax_telemetry
    from trlx_tpu.utils.aotjit import aot_jit as jax_aot_jit

    jax_session = jax_telemetry.start()
    session = telemetry.start()
    theirs, mine = jax_aot_jit(_fn), aot_jit(_fn)
    for i, (tree, scale, bf16, want) in enumerate(_calls()):
        jtree = _convert(tree, lambda x: jnp.asarray(
            x, jnp.bfloat16 if bf16 else jnp.float32))
        ttree = _convert(tree, lambda x: torch.from_numpy(x).to(
            torch.bfloat16 if bf16 else torch.float32))
        ref = np.asarray(theirs(jtree, scale), np.float32)
        out = mine(ttree, scale).float().numpy()
        # bf16: both round x * scale and the sum once, in their own order
        np.testing.assert_allclose(out, ref, rtol=1e-2 if bf16 else 1e-6,
                                   atol=1e-2 if bf16 else 0)
        counts = (jax_session.registry.counters.get("compile/recompiles", 0),
                  session.registry.counters["compile/recompiles"])
        assert counts == (want, want), (i, counts)
    assert mine.signatures() == 5
    assert mine.graphs() == []  # CPU arguments: keyed, never captured


def test_cpu_calls_run_directly_and_predeclare_the_counter():
    session = telemetry.start()
    assert session.registry.counters["compile/recompiles"] == 0.0
    seen = []

    def fn(x, n):
        seen.append(x)
        return x + n

    wrapped = aot_jit(fn)
    x = torch.ones(3)
    assert torch.equal(wrapped(x, 1), torch.full((3,), 2.0))
    assert torch.equal(wrapped(x, 1), torch.full((3,), 2.0))
    assert len(seen) == 2 and all(t is x for t in seen)  # fn ran each time
    leaves, structure = tree_flatten(({"b": x, "a": None}, [1, (x,)]))
    assert leaves == [x, 1, x]  # dict keys sorted; None is an empty node
    assert structure == tree_flatten(({"a": None, "b": x}, [1, (x,)]))[1]


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("failures,retried", [(0, 0), (1, 1), (2, 2),
                                              (3, None)])
def test_invalidated_capture_is_taken_again(monkeypatch, failures,
                                            retried):
    """``_capture`` takes an invalidated capture again, up to
    CAPTURE_ATTEMPTS times, counting each retry; the last failure, and
    any other capture error at once, raises. (The streams are stubbed:
    this is the policy; the card case below is the real capture.)"""
    import contextlib

    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    session = telemetry.start()
    wrapped = aot_jit(lambda x: x + 1)
    attempts = []

    def capture_once(args, leaves, device):
        attempts.append(1)
        if len(attempts) <= failures:
            raise RuntimeError("CUDA error: operation failed due to a "
                               "previous error during capture\nSearch for "
                               "`cudaErrorStreamCaptureInvalidated'")
        return "entry"

    monkeypatch.setattr(wrapped, "_capture_once", capture_once)
    x = torch.ones(2)
    if retried is None:
        with pytest.raises(RuntimeError, match="Invalidated"):
            wrapped._capture((x,), [x], "cuda")
        assert len(attempts) == aotjit.CAPTURE_ATTEMPTS
    else:
        entry, out = wrapped._capture((x,), [x], "cuda")
        assert entry == "entry" and torch.equal(out, x + 1)
    assert session.registry.counters.get("compile/capture_retries",
                                         0.0) == (retried if retried is
                                                  not None else 2)

    def broken(args, leaves, device):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(wrapped, "_capture_once", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        wrapped._capture((x,), [x], "cuda")


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_graph_replays_with_launches_and_weight_swaps():
    """A layer of paged decode behind a matmul: the first call runs
    eagerly (one launch counted) and captures (one launch recorded, not
    counted), each replay adds the record; in-place weight updates are
    read, a rebound weight is copied in."""
    from trlx_tpu_torch.ops.paged_attention import paged_decode_attention

    dev = _card()
    g = torch.Generator(device=dev)
    S, H, hd, page, pages = 2, 2, 16, 4, 3
    k = torch.randn(S * pages, page, H, hd, device=dev, generator=g)
    v = torch.randn(S * pages, page, H, hd, device=dev, generator=g)
    pt = torch.arange(S * pages, device=dev, dtype=torch.int32).view(S, pages)
    bias = torch.zeros(S, pages * page, device=dev)
    w = torch.randn(hd, hd, device=dev, generator=g)
    q = torch.randn(S, H, hd, device=dev, generator=g)

    def fn(w, q, k, v, pt, bias):
        return paged_decode_attention((q @ w).contiguous(), k, v, pt, bias)

    def eager(w):
        return paged_decode_attention((q @ w).contiguous(), k, v, pt, bias)

    wrapped = aot_jit(fn)
    ops.reset_launches()
    first = wrapped(w, q, k, v, pt, bias)
    assert ops.LAUNCHES["paged_decode"] == 1
    (entry,) = wrapped.graphs()
    assert entry.launches == {"paged_decode": 1}
    out = wrapped(w, q, k, v, pt, bias)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode"] == 2  # the eager call + 1 replay
    torch.testing.assert_close(out, first, rtol=0, atol=0)
    w.mul_(-1.0)  # updated in place: the replay reads it
    out = wrapped(w, q, k, v, pt, bias).clone()
    torch.testing.assert_close(out, eager(w), rtol=1e-5, atol=1e-5)
    rebound = torch.randn(hd, hd, device=dev, generator=g)
    out = wrapped(rebound, q, k, v, pt, bias).clone()
    torch.testing.assert_close(out, eager(rebound), rtol=1e-5, atol=1e-5)
    assert torch.equal(w, rebound)  # copied into the captured input
    assert len(wrapped.graphs()) == 1


@pytest.mark.cuda
def test_cuda_graph_draws_follow_the_generator():
    """A draw inside the graph reads the generator at replay time: after
    ``manual_seed(s)`` a replay draws what an eager call draws after the
    same seed, two replays without a re-seed draw afresh, and the
    generator ends in the eager path's state."""
    dev = _card()
    g = torch.Generator(device=dev)
    logits = torch.randn(4, 300, device=dev)

    def fn(gen, logits):
        race = torch.empty_like(logits).exponential_(generator=gen)
        return torch.argmax(torch.softmax(logits, -1) / race, dim=-1)

    wrapped = aot_jit(fn)
    draws = {}
    for graphs in (False, True):
        aotjit.CUDA_GRAPHS = graphs
        try:
            runs = []
            for seed in (5, 6, 5):
                g.manual_seed(seed)
                runs.append([wrapped(g, logits).clone() for _ in range(3)])
            draws[graphs] = (runs, g.get_state())
        finally:
            aotjit.CUDA_GRAPHS = True
    (eager, eager_state), (graph, graph_state) = draws[False], draws[True]
    for a, b in zip(eager, graph):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(eager_state, graph_state)
    assert not all(torch.equal(graph[0][0], x) for x in graph[0][1:])
    assert all(torch.equal(x, y) for x, y in zip(graph[0], graph[2]))
    assert len(wrapped.graphs()) == 1


@pytest.mark.cuda
def test_cuda_capture_invalidated_by_another_thread_is_taken_again():
    """Another thread keeps launching on the card during a capture (the
    capture holds), then synchronises the whole device inside one (CUDA
    refuses the sync there and invalidates the capture): the capture is
    taken again, ``compile/capture_retries`` counts 1, and the replays
    draw what the eager path draws from the same generator state."""
    import threading

    dev = _card()
    session = telemetry.start()
    g = torch.Generator(device=dev)
    w = torch.randn(256, 256, device=dev) / 16
    logits = torch.randn(4, 300, device=dev)
    release, began, synced = (threading.Event() for _ in range(3))
    state = {"armed": False, "launches": 0, "sync_error": None}

    def other_thread():
        x = torch.randn(64, 256, device=dev)
        while not release.is_set():
            x = torch.tanh(x @ w)
            state["launches"] += 1
            if state["armed"] and began.is_set() and not synced.is_set():
                try:
                    torch.cuda.synchronize()
                except Exception as e:  # refused during a capture
                    state["sync_error"] = e
                synced.set()

    def fn(gen, logits):
        race = torch.empty_like(logits).exponential_(generator=gen)
        return torch.argmax(torch.softmax(logits, -1) / race, dim=-1)

    real_begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(graph, *args, **kwargs):
        real_begin(graph, *args, **kwargs)
        if state["armed"] and not synced.is_set():
            began.set()
            assert synced.wait(30)

    worker = threading.Thread(target=other_thread, daemon=True)
    worker.start()
    try:
        torch.cuda.CUDAGraph.capture_begin = capture_begin
        for armed in (False, True):
            state["armed"] = armed
            wrapped = aot_jit(fn)
            g.manual_seed(7)
            first = [wrapped(g, logits).clone() for _ in range(3)]
            aotjit.CUDA_GRAPHS = False
            try:
                g.manual_seed(7)
                eager = [wrapped(g, logits).clone() for _ in range(3)]
            finally:
                aotjit.CUDA_GRAPHS = True
            for x, y in zip(first, eager):
                assert torch.equal(x, y)
            assert len(wrapped.graphs()) == 1
            assert session.registry.counters.get(
                "compile/capture_retries", 0.0) == float(armed)
    finally:
        torch.cuda.CUDAGraph.capture_begin = real_begin
        release.set()
        worker.join(30)
    assert state["launches"] > 0 and "capturing" in str(state["sync_error"])


def test_collector_paused_nests_across_threads_and_restores():
    """The cycle collector stays off while any thread is inside
    ``collector_paused`` and comes back as it was when the last leaves:
    on if it was on, off if the caller had turned it off."""
    import gc
    import threading

    was = gc.isenabled()
    try:
        gc.enable()
        inside, leave = threading.Event(), threading.Event()

        def other():
            with aotjit.collector_paused():
                inside.set()
                leave.wait(30)

        worker = threading.Thread(target=other)
        worker.start()
        assert inside.wait(30)
        assert not gc.isenabled()
        with aotjit.collector_paused():
            with aotjit.collector_paused():
                assert not gc.isenabled()
            leave.set()
            worker.join(30)
            assert not gc.isenabled()
        assert gc.isenabled()
        gc.disable()
        with aotjit.collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()


@pytest.mark.cuda
def test_cuda_capture_runs_no_collection():
    """No cycle collection starts while aot_jit captures, however low
    the collector's threshold: one could free a dead reference cycle
    holding another CUDA graph (an engine dropped earlier), which CUDA
    refuses to destroy on a capturing thread, and the capture is lost.
    Collections start again after it, and the graph replays as the
    first call returned."""
    import gc

    dev = _card()
    telemetry.start()
    x = torch.randn(64, 64, device=dev)
    starts = []

    def watch(phase, info):
        if phase == "start":
            starts.append(torch.cuda.is_current_stream_capturing())

    def fn(a):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)
            [[] for _ in range(1000)]  # a collection's trigger, were it on
        return a @ a

    threshold = gc.get_threshold()
    gc.callbacks.append(watch)
    try:
        wrapped = aot_jit(fn)
        first = wrapped(x).clone()
        [[] for _ in range(1000)]
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
    assert len(wrapped.graphs()) == 1
    assert starts and not any(starts), starts
    assert torch.equal(wrapped(x), first)
