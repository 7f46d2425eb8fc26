"""The port's serving path (trlx_tpu_torch.serve) against trlx_tpu's, on
the CPU: the engine + continuous-batching slot scheduler emit greedy
tokens IDENTICAL to trlx_tpu's slot engine (``attention: jnp``) on the
staggered shared-prefix ``ROWS`` trace at page sizes 3, 8 and 24, with
the same radix prefix hits — under both port attention paths (the plain
gather and the kernel seam, which runs its plain version on the CPU).
Plus one end-to-end request through the port's HTTP server, the CLI's
parsing, and the no-silent-CPU-fallback device rule."""

import json
import urllib.request

import numpy as np

import jax
import pytest
import torch

from test_paged import build_engine
from test_paged_kernel import ROWS
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models.params import (
    decode_views_from_numpy,
    init_decode_views,
    load_decode_views,
    save_decode_views,
)
from trlx_tpu_torch.models.transformer import tree_map
from trlx_tpu_torch.serve import (
    InferenceEngine,
    InferenceServer,
    ServeConfig,
    SlotScheduler,
)
from trlx_tpu_torch.serve.__main__ import build_parser, serve_config_from_args
from trlx_tpu_torch.utils import resolve_device

BUCKETS = [[2, 8, 8], [4, 8, 8]]


def _run_staggered(s, max_new=8):
    first = [s.submit(list(r), max_new_tokens=max_new) for r in ROWS[:2]]
    for r in first:
        r.wait(timeout=60.0)
    second = [s.submit(list(r), max_new_tokens=max_new) for r in ROWS[2:]]
    for r in second:
        r.wait(timeout=60.0)
    return [r.result for r in first + second]


def _run(scheduler):
    scheduler.warmup()
    scheduler.start()
    try:
        return _run_staggered(scheduler)
    finally:
        scheduler.stop()


def _port_engine(views, **serve):
    telemetry.start()
    cfg = ServeConfig(**{"buckets": BUCKETS, "max_queue": 64, "slots": 4,
                         "page_size": 4, **serve})
    return InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                           serve=cfg, views=views, device="cpu")


@pytest.mark.parametrize("page_size", [3, 8, 24])
def test_slot_engine_greedy_tokens_identical_to_trlx_tpu(page_size):
    jax_engine = build_engine(attention="jnp", page_size=page_size,
                              buckets=BUCKETS)
    tree = jax.device_get(jax_engine._init_params())
    views = decode_views_from_numpy(tree, jax_engine.spec, 1)
    expected = _run(JaxSlotScheduler(jax_engine))
    jax_saved = jax_telemetry.current().registry.counters.get(
        "serve/prefix_tokens_saved", 0.0)
    for attention in ("jnp", "pallas"):
        engine = _port_engine(views, page_size=page_size,
                              attention=attention)
        s = SlotScheduler(engine)
        got = _run(s)
        assert got == expected, (
            f"{attention} path diverged from trlx_tpu at page_size="
            f"{page_size}")
        saved = telemetry.current().registry.counters.get(
            "serve/prefix_tokens_saved", 0.0)
        assert saved == jax_saved
        if page_size < 8:
            assert saved > 0
        assert s.free_slots() == s.runtime.num_slots
        assert s.runtime.steps > 0


def test_soak_mixed_lengths_no_recompiles_no_leaks():
    """Many mixed-length requests through the port's slot scheduler (as
    tests/test_slots.py's soak drives trlx_tpu's): after warmup no
    signature is new (``compile/recompiles`` stays 0, in /healthz's
    terms too), every slot and page returns (no refcount left, every
    page free or cached), and each response holds exactly its own
    ``max_new_tokens`` unless eos ended it."""
    engine = _port_engine(None, attention="pallas", page_size=4,
                          buckets=[[2, 8, 8], [4, 8, 8], [4, 16, 8]])
    s = SlotScheduler(engine, max_queue=256)
    s.warmup()
    s.start()
    rng = np.random.default_rng(0)
    shared = [int(t) for t in rng.integers(0, 250, 8)]
    try:
        reqs = []
        for i in range(80):
            plen = int(rng.integers(1, 16))
            tokens = [int(t) for t in rng.integers(0, 250, plen)]
            if i % 3 == 0:  # a committed prefix page to hit
                tokens = (shared + tokens)[:15]
            mn = int(rng.integers(1, 9))
            reqs.append(s.submit(tokens, max_new_tokens=mn))
        for r in reqs:
            r.wait(timeout=120.0)
    finally:
        s.stop()
    eos = engine.tokenizer.eos_token_id
    for r in reqs:
        ended = bool(r.result) and r.result[-1] == eos
        assert len(r.result) == r.max_new_tokens or (
            ended and len(r.result) < r.max_new_tokens), (r.max_new_tokens,
                                                          r.result)
    counters = telemetry.current().registry.counters
    assert counters["compile/recompiles"] == 0.0
    assert counters["serve/admissions"] == counters["serve/evictions"] \
        == counters["serve/responses"] == 80.0
    assert counters.get("serve/request_errors", 0.0) == 0.0
    assert counters["serve/prefix_tokens_saved"] > 0
    assert s.free_slots() == s.runtime.num_slots
    cache, pages = s.cache, s.runtime.num_pages
    assert all(cache.allocator.refcount(p) == 0 for p in range(pages))
    assert cache.free_pages() + cache.cached_pages() == pages


def test_submit_after_a_server_stop_raises_instead_of_queueing():
    """A server's shutdown stops its scheduler for good (``final``): a
    request that reaches it afterwards (an HTTP handler racing the
    shutdown) raises at once, as the requests the stop failed do;
    queued, nothing would ever decode or fail it, and its handler would
    wait out the whole request timeout. A plain stop() still queues a
    request for the next start(), which decodes it."""
    engine = _port_engine(None)
    s = SlotScheduler(engine)
    s.start()
    s.stop()
    req = s.submit([1, 2, 3], max_new_tokens=2)
    s.start()
    try:
        assert 0 < len(req.wait(timeout=60.0).result) <= 2
    finally:
        s.stop()
    server = InferenceServer(engine, host="127.0.0.1", port=0)
    server.start(warmup=False)
    server.stop()
    with pytest.raises(RuntimeError, match="scheduler stopped"):
        server.scheduler.submit([1, 2, 3], max_new_tokens=2)
    assert server.scheduler.queue_depth() == 0


@pytest.mark.parametrize("page_size", [3, 64])
def test_engine_lattice_and_page_geometry_match_trlx_tpu(page_size):
    buckets = [[4, 8, 8], [2, 8, 8], [2, 16, 4]]
    jax_engine = build_engine(attention="jnp", page_size=page_size,
                              buckets=buckets, slots=0)
    engine = _port_engine(None, page_size=page_size, buckets=buckets,
                          slots=0)
    assert engine.buckets == jax_engine.buckets
    for name in ("prompt_classes", "slot_count", "slot_buffer_len",
                 "page_size_tokens", "pages_per_slot", "page_count",
                 "default_max_new_tokens"):
        assert getattr(engine, name)() == getattr(jax_engine, name)(), name
    for p, g in ((1, 1), (8, 8), (9, 3), (16, 4)):
        assert engine.pick_shape(p, g) == jax_engine.pick_shape(p, g)
        assert engine.request_page_need(p, g) == \
            jax_engine.request_page_need(p, g)
    with pytest.raises(ValueError, match="fits no serve bucket"):
        engine.pick_shape(17, 1)
    rows = [[5, 6, 7], list(range(1, 12))]
    for got, want in zip(engine.pad_batch(rows, (4, 8, 8)),
                         jax_engine.pad_batch(rows, (4, 8, 8))):
        np.testing.assert_array_equal(got, want)


def test_weights_file_round_trip(tmp_path):
    """The serve CLI's ``--weights`` file: views saved with torch.save
    load back leaf for leaf."""
    spec = TRLConfig.from_dict(tiny_config_dict()).model.resolve_spec()
    views = init_decode_views(spec, seed=3, num_layers_unfrozen=1)
    path = str(tmp_path / "views.pt")
    save_decode_views(views, path)
    loaded = load_decode_views(path)

    def leaves(tree):
        out = []
        tree_map(out.append, tree)
        return out

    assert isinstance(loaded.blocks, tuple) and len(loaded.blocks) == 2
    assert loaded.embed.keys() == views.embed.keys()
    saved, back = leaves(tuple(views)), leaves(tuple(loaded))
    assert len(saved) == len(back) > 0
    assert all(torch.equal(x, y) for x, y in zip(saved, back))


def test_http_generate_healthz_metrics():
    engine = _port_engine(None, attention="pallas")
    direct = SlotScheduler(engine)
    expected = _run(direct)
    server = InferenceServer(engine, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        req = urllib.request.Request(
            f"{base}/generate",
            data=json.dumps({"tokens": ROWS[1], "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["tokens"] == expected[1]
        assert body["bucket"] == [8, 8]
        req = urllib.request.Request(
            f"{base}/generate",
            data=json.dumps({"prompt": "hi", "max_new_tokens": 3}).encode(),
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert len(json.loads(resp.read())["tokens"]) <= 3
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["kv"]["kv_layout"] == "paged"
        assert health["recompiles"] == 0.0
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
            counters = json.loads(resp.read())["counters"]
        # four from the direct run, two over HTTP
        assert counters["serve/responses"] == 6.0
        assert counters["compile/recompiles"] == 0.0
        bad = urllib.request.Request(f"{base}/generate", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
    finally:
        server.stop()


def test_cli_layers_flags_over_serve_section():
    args = build_parser().parse_args([
        "--config", "x.json", "--buckets", "8x16x48,16x16x48",
        "--slots", "16", "--page-size", "16", "--attention", "pallas",
    ])
    cfg = serve_config_from_args(args, {"serve": {"attention": "jnp",
                                                  "max_queue": 9}})
    assert cfg.buckets == [[8, 16, 48], [16, 16, 48]]
    assert (cfg.slots, cfg.page_size, cfg.attention, cfg.max_queue) == (
        16, 16, "pallas", 9)
    # tenants are honoured since the serve-lifecycle slice, the tp serve
    # mesh since the serve-mesh slice
    assert ServeConfig.from_dict({"tenants": {"a": {"rps": 1.0}}}
                                 ).tenants == {"a": {"rps": 1.0}}
    assert ServeConfig.from_dict({"mesh": {"tp": 2}}).mesh == {"tp": 2}


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """No card and no explicit ``device="cpu"``: the entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(TRLConfig.from_dict(tiny_config_dict()),
                        serve=ServeConfig())
    assert resolve_device("cpu") == torch.device("cpu")
