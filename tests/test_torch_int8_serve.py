"""The port's int8 serving tiers against trlx_tpu's, on the CPU, from the
same numpy weights at float32: ``quantize_serve_weights`` (codes equal,
scales within 1 ulp, a layer at a time equal to the stacked
computation), the int8 projection, the int8-weight slot engine (greedy
tokens identical to trlx_tpu's int8-weight engine, ``serve/model_gb``
counting the int8 bytes), and the int8 KV page pool: the quantizer's
error bound, prefill + decode logits against trlx_tpu's int8 pool and
within trlx_tpu's pinned tolerance of the bf16 pool
(tests/test_paged_kernel.py's 0.1), the int8 engine's greedy tokens
identical to trlx_tpu's int8 engine at page sizes 3, 8 and 24 on both
port attention paths (the kernel seam runs its plain version here), and
quantized pages staying content-addressable for the radix cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paged import build_engine
from test_paged_kernel import ROWS
from test_serve import tiny_config_dict
from trlx_tpu import telemetry as jax_telemetry
from trlx_tpu.models import generation as jg
from trlx_tpu.models import transformer as jt
from trlx_tpu.serve.engine import quantize_serve_weights as jax_quantize
from trlx_tpu.serve.slots import SlotScheduler as JaxSlotScheduler
from trlx_tpu_torch import telemetry
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.models import generation as tg
from trlx_tpu_torch.models import transformer as tt
from trlx_tpu_torch.models.params import decode_views_from_numpy
from trlx_tpu_torch.serve import InferenceEngine, ServeConfig, SlotScheduler
from trlx_tpu_torch.serve.engine import quantize_serve_weights

BUCKETS = [[2, 8, 8], [4, 8, 8]]


@pytest.fixture(scope="module")
def tree():
    """trlx_tpu's tiny policy as numpy (the weights both packages load)."""
    return jax.device_get(build_engine()._init_params())


def port_engine(tree, **serve):
    telemetry.start()
    cfg = TRLConfig.from_dict(tiny_config_dict())
    spec = cfg.model.resolve_spec()
    return InferenceEngine(
        cfg, serve=ServeConfig(**{"buckets": BUCKETS, "max_queue": 64,
                                  "slots": 4, "page_size": 4, **serve}),
        views=decode_views_from_numpy(tree, spec, 1), device="cpu")


def run_staggered(s, max_new=8):
    s.warmup()
    s.start()
    try:
        first = [s.submit(list(r), max_new_tokens=max_new) for r in ROWS[:2]]
        for r in first:
            r.wait(timeout=60.0)
        second = [s.submit(list(r), max_new_tokens=max_new)
                  for r in ROWS[2:]]
        for r in second:
            r.wait(timeout=60.0)
        return [r.result for r in first + second]
    finally:
        s.stop()


def jax_tokens(tree, **serve):
    engine = build_engine(buckets=BUCKETS, **serve)
    engine._install_params(tree)
    return run_staggered(JaxSlotScheduler(engine))


# --------------------------------------------------------------------- #
# int8 serve weights
# --------------------------------------------------------------------- #


def test_quantize_serve_weights_matches_trlx_tpu(tree):
    blocks = (tree["frozen_base"]["blocks"], tree["trainable"]["blocks"])
    theirs = jax.device_get(jax_quantize(
        jax.tree_util.tree_map(jnp.asarray, blocks)))
    ours = quantize_serve_weights(tt.tree_map(torch.tensor, blocks))
    n = 0
    for seg_o, seg_t in zip(ours, theirs):
        for part in ("attn", "mlp"):
            for name, leaf in seg_o[part].items():
                if not isinstance(leaf, tuple):
                    assert name not in ("wq", "wk", "wv", "wo", "w_in",
                                        "w_out"), name
                    continue
                codes, scale = leaf
                t_codes, t_scale = seg_t[part][name]
                assert codes.dtype == torch.int8 and scale.shape == (
                    codes.shape[0], 1, codes.shape[2])
                np.testing.assert_array_equal(codes.numpy(),
                                              np.asarray(t_codes))
                np.testing.assert_array_max_ulp(scale.numpy(),
                                                np.asarray(t_scale), 1)
                # a layer at a time is the stacked computation
                x = torch.tensor(np.asarray(
                    (tree["frozen_base"]["blocks"] if seg_o is ours[0]
                     else tree["trainable"]["blocks"])[part][name]))
                s = x.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-8
                assert torch.equal(scale, s)
                assert torch.equal(codes, torch.clamp(
                    torch.round(x / s), -127, 127).to(torch.int8))
                n += 1
    assert n == 2 * 6  # wq wk wv wo w_in w_out in each segment
    # a quantized tree passes through untouched
    again = quantize_serve_weights(ours)
    assert again[0]["attn"]["wq"][0] is ours[0]["attn"]["wq"][0]


def test_int8_projection_matches_trlx_tpu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jw = jax_quantize({"attn": {"wq": jnp.asarray(w[None])}})["attn"]["wq"]
    want = jt._project(jnp.asarray(x), (jw[0][0], jw[1][0]), jnp.asarray(b))
    tw = quantize_serve_weights({"attn": {"wq": torch.from_numpy(w[None])}})
    codes, scale = tw["attn"]["wq"]
    got = tt._project(torch.from_numpy(x), (codes[0], scale[0]),
                      torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # and it stays near the float projection (per-channel int8)
    dense = x @ w + b
    assert np.abs(got.numpy() - dense).max() < 0.05 * np.abs(dense).max()


def test_int8_weights_engine_tokens_identical_to_trlx_tpu(tree):
    want = jax_tokens(tree, weights_dtype="int8")
    jax_gb = jax_telemetry.current().registry.gauges["serve/model_gb"]
    full = port_engine(tree)
    full_gb = telemetry.current().registry.gauges["serve/model_gb"]
    engine = port_engine(tree, weights_dtype="int8")
    registry = telemetry.current().registry
    gb = registry.gauges["serve/model_gb"]
    assert gb < full_gb
    # the kept bytes are trlx_tpu's: int8 codes, float32 scales, float32
    # embeddings, norms and biases at this float32 compute dtype
    assert gb == pytest.approx(jax_gb, rel=1e-6)
    wq = engine.blocks[1]["attn"]["wq"]
    assert isinstance(wq, tuple) and wq[0].dtype == torch.int8 \
        and wq[1].dtype == torch.float32
    assert run_staggered(SlotScheduler(engine)) == want
    assert registry.counters["compile/recompiles"] == 0.0
    # the first step's logits track the float weights' (printed gap)
    logits = {}
    for name, e in (("bf16", full), ("int8", engine)):
        s = SlotScheduler(e)
        tokens = np.zeros((2, 8), np.int32)
        mask = np.zeros((2, 8), np.int32)
        tokens[0, :5], mask[0, :5] = ROWS[0], 1
        s.runtime.prefill((2, 8), tokens, mask, np.asarray([0, 4]),
                          np.asarray([4, 1]),
                          page_tables=np.asarray([[0, 1, 2, 3], [16] * 4]),
                          start=np.zeros(2, np.int32))
        logits[name] = s.runtime.state.logits[0].numpy()
    gap = np.abs(logits["int8"] - logits["bf16"]).max()
    print(f"int8 weights: first-step logit gap to float weights {gap:.4f}")
    assert gap < 0.1 * np.abs(logits["bf16"]).max()


# --------------------------------------------------------------------- #
# the int8 KV tier
# --------------------------------------------------------------------- #


def test_int8_roundtrip_error_bound_per_page():
    """|x - dq(q(x))| <= scale / 2 elementwise (tests/test_paged_kernel.py's
    contract), an all-zero page included, and the codes equal
    trlx_tpu's quantize_kv."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((6, 4, 2, 16)) * 3.0).astype(np.float32)
    x[2] = 0.0
    codes, scale = tt.quantize_kv(torch.from_numpy(x))
    dq = tt.dequantize_kv(codes, scale, torch.float32)
    err = np.abs(x - dq.numpy())
    assert (err <= scale.numpy()[..., None] / 2.0 + 1e-6).all()
    assert (err.max(axis=-1) <= np.abs(x).max(axis=-1) / 254.0 + 1e-6).all()
    jc, js = jt.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(scale.numpy(), np.asarray(js), 1)


def test_int8_pool_logits_match_trlx_tpu_and_track_bf16(tree):
    """Prefill + 4 greedy steps over an int8 page pool: logits against
    trlx_tpu's int8 pool, and within its pinned 0.1 of the bf16 pool."""
    engine = port_engine(tree)
    spec = engine.spec
    jengine = build_engine()
    jspec, jcfg = jengine.spec, jengine._gen_base._replace(gen_size=8)
    jengine._install_params(tree)
    cfg = engine.gen_config._replace(gen_size=8)
    S, ps, max_pages, Np = 2, 4, 4, 8
    t = np.zeros((S, 8), np.int32)
    m = np.zeros((S, 8), np.int32)
    for i, row in enumerate([[3, 1, 4, 1, 5], [9, 2, 6]]):
        t[i, :len(row)] = row
        m[i, :len(row)] = 1
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    trace = {}
    for tier in ("bf16", "int8"):
        tpool = tg.init_page_pool(spec, [1, 1], Np, ps,
                                  torch.int8 if tier == "int8"
                                  else torch.bfloat16)
        tstate = tg.init_slot_state(S, max_pages * ps, 257, max_pages)
        jpool = jg.init_page_pool(jspec, [1, 1], Np, ps,
                                  cache_dtype=jnp.int8 if tier == "int8"
                                  else jnp.bfloat16)
        jstate = jg.init_slot_state(S, max_pages * ps, 257,
                                    max_pages=max_pages)
        jpool, jstate = jax.jit(lambda pool, st, pt: jg.prefill_into_slots(
            jspec, jengine.blocks, jengine.embed, jengine.ln_f, pool, st, t,
            m, np.arange(S, dtype=np.int32), np.full((S,), 8, np.int32),
            compute_dtype=jnp.float32, page_tables=pt, page_size=ps,
            start=np.zeros((S,), np.int32)))(jpool, jstate, tables)
        tg.prefill_into_slots(
            spec, engine.blocks, engine.embed, engine.ln_f, tpool, tstate, t,
            m, np.arange(S), np.full((S,), 8), compute_dtype=torch.float32,
            page_tables=tables, page_size=ps, start=np.zeros(S))
        ours, theirs = [tstate.logits.clone()], [np.asarray(jstate.logits)]
        step = jax.jit(lambda pool, st, seed: jg.decode_step(
            jspec, jengine.blocks, jengine.embed, jengine.ln_f, pool, st,
            seed, jcfg, compute_dtype=jnp.float32))
        for i in range(4):
            jpool, jstate, jtok, _, _ = step(jpool, jstate, np.int32(i))
            _, _, tok, _, _ = tg.decode_step(
                spec, engine.blocks, engine.embed, engine.ln_f, tpool,
                tstate, None, cfg, compute_dtype=torch.float32)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            ours.append(tstate.logits.clone())
            theirs.append(np.asarray(jstate.logits))
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), b, atol=2e-3)
        trace[tier] = ours
    for a, b in zip(trace["bf16"], trace["int8"]):
        assert (a - b).abs().max() < 0.1, \
            "int8 KV logits drifted past the pinned tolerance"


@pytest.mark.parametrize("page_size", [3, 8, 24])
def test_int8_engine_tokens_identical_to_trlx_tpu(tree, page_size):
    want = jax_tokens(tree, kv_dtype="int8", page_size=page_size)
    for attention in ("jnp", "pallas"):
        engine = port_engine(tree, kv_dtype="int8", page_size=page_size,
                             attention=attention)
        s = SlotScheduler(engine)
        k_pool = s.runtime.pool[0][0]
        assert isinstance(k_pool, tuple) and k_pool[0].dtype == torch.int8
        assert run_staggered(s) == want, (attention, page_size)
        counters = telemetry.current().registry.counters
        assert counters["compile/recompiles"] == 0.0
        stats = s.pool_stats()
        assert stats["kv_dtype"] == "int8"
        assert stats["kv_bytes_per_token"] == 2 * 2 * 4 * (16 + 4)
        assert stats["pages_free"] + stats["pages_cached"] \
            == stats["pages_total"]


def test_int8_prefix_pages_remain_content_addressable(tree):
    engine = port_engine(tree, kv_dtype="int8", buckets=[[2, 16, 8]])
    s = SlotScheduler(engine)
    s.warmup()
    s.start()
    try:
        prompt = [7, 7, 7, 7, 5, 5, 5, 5, 1, 2, 3, 4]
        a = s.submit(prompt, max_new_tokens=4)
        a.wait(timeout=60.0)
        b = s.submit(prompt, max_new_tokens=4)  # 2 of 3 blocks hit
        b.wait(timeout=60.0)
        saved = telemetry.current().registry.counters[
            "serve/prefix_tokens_saved"]
        assert saved == 8.0, "repeat prompt did not hit quantized pages"
        assert a.result == b.result
        assert s.pool_stats()["pages_cached"] > 0
    finally:
        s.stop()


def test_int8_tiers_refused_where_trlx_tpu_refuses(tree):
    from trlx_tpu.data.configs import TRLConfig as JaxConfig
    from trlx_tpu.serve import InferenceEngine as JaxEngine
    from trlx_tpu.serve import ServeConfig as JaxServe

    for bad in (dict(kv_layout="contiguous", kv_dtype="int8"),
                dict(kv_dtype="fp8"), dict(weights_dtype="int4")):
        with pytest.raises(ValueError) as theirs:
            JaxEngine(JaxConfig.from_dict(tiny_config_dict()),
                      serve=JaxServe(**bad), init=False)
        with pytest.raises(ValueError) as ours:
            port_engine(tree, **bad)
        assert str(ours.value) == str(theirs.value)
