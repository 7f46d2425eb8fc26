"""The port's slot-pool primitives (trlx_tpu_torch.models.generation)
against trlx_tpu's, from the same numpy weights at float32 over a bf16
page pool: ``prefill_into_slots`` in both variants (a cold admission with
a filler row, then a radix-hit admission whose suffix attends to a
committed prefix page) at page sizes 3 and 8, followed by greedy
``decode_step``s with the kernel seam — pool pages, every lane and the
carried logits at 2e-4, the emitted tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelSpec as JaxSpec
from trlx_tpu.models import generation as jg
from trlx_tpu.ops.sampling import SamplingParams as JaxSampling
from trlx_tpu_torch.data.configs import ModelSpec
from trlx_tpu_torch.models import generation as tg
from trlx_tpu_torch.models.params import (
    decode_views_from_numpy,
    init_hydra_numpy,
)
from trlx_tpu_torch.ops.paged_attention import make_paged_decode_fn
from trlx_tpu_torch.ops.sampling import SamplingParams

ATOL = 2e-4
SPEC = dict(arch="gpt2", vocab_size=257, n_layer=2, n_head=4, d_model=32,
            n_positions=32)
S = 3  # slots


def _jax_views(tree):
    bottom = tree["frozen_base"]["blocks"]
    top = tree["trainable"]["blocks"]
    embed = dict(tree["frozen_base"]["embed"])
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return (to(bottom), to(top)), to(embed), to(tree["trainable"]["ln_f"])


def _pool_np(pool, num_pages):
    out = []
    for k, v in pool:
        for x in (k, v):
            if torch.is_tensor(x):
                out.append(x[:, :num_pages].float().numpy())
            else:
                out.append(np.asarray(x.astype(jnp.float32)))
    return out


def _check(tstate, jstate, tpool, jpool, num_pages):
    for name in tg.SlotState._fields:
        mine = getattr(tstate, name).numpy()
        theirs = np.asarray(getattr(jstate, name))
        if name == "logits":
            rows = np.asarray(jstate.active)
            np.testing.assert_allclose(mine[rows], theirs[rows], atol=ATOL)
        else:
            np.testing.assert_array_equal(mine, theirs, err_msg=name)
    for mine, theirs in zip(_pool_np(tpool, num_pages),
                            _pool_np(jpool, num_pages)):
        np.testing.assert_allclose(mine, theirs, atol=ATOL)


def _right_pad(rows, P, pad=256):
    tokens = np.full((len(rows), P), pad, np.int32)
    mask = np.zeros((len(rows), P), np.int32)
    for i, r in enumerate(rows):
        tokens[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return tokens, mask


@pytest.mark.parametrize("page_size", [3, 8])
def test_prefill_both_variants_and_decode_match_jax(page_size):
    spec, jspec = ModelSpec(**SPEC), JaxSpec(**SPEC)
    tree = init_hydra_numpy(spec, num_layers_unfrozen=1, seed=11)
    views = decode_views_from_numpy(tree, spec, 1)
    jblocks, jembed, jln = _jax_views(tree)
    seg_sizes = [1, 1]
    max_pages = -(-16 // page_size)
    T = max_pages * page_size
    num_pages = S * max_pages
    P = 8

    jpool = jg.init_page_pool(jspec, seg_sizes, num_pages, page_size)
    jstate = jg.init_slot_state(S, T, 257, max_pages=max_pages)
    tpool = tg.init_page_pool(spec, seg_sizes, num_pages, page_size)
    tstate = tg.init_slot_state(S, T, 257, max_pages)

    def admit(tokens, mask, slot_ids, max_new, tables, start, suffix):
        nonlocal jpool, jstate, tpool, tstate
        jpool, jstate = jax.jit(
            lambda pool, st, *host: jg.prefill_into_slots(
                jspec, jblocks, jembed, jln, pool, st, *host[:4],
                compute_dtype=jnp.float32, page_tables=host[4],
                page_size=page_size, start=host[5], prefix_context=suffix,
            )
        )(jpool, jstate, tokens, mask, slot_ids, max_new, tables, start)
        tpool, tstate = tg.prefill_into_slots(
            spec, views.blocks, views.embed, views.ln_f, tpool, tstate,
            tokens, mask, slot_ids, max_new, compute_dtype=torch.float32,
            page_tables=tables, page_size=page_size, start=start,
            prefix_context=suffix,
        )
        _check(tstate, jstate, tpool, jpool, num_pages)

    # cold admission: two prompts into slots 2 and 0, one filler row
    prompt_a = [3, 1, 4, 1, 5, 9, 2, 6]
    tokens, mask = _right_pad([prompt_a, [7, 7, 2], [1]], P)
    tables = np.full((3, max_pages), num_pages, np.int32)
    tables[0] = np.arange(max_pages)
    tables[1] = np.arange(max_pages, 2 * max_pages)
    admit(tokens, mask, np.asarray([2, 0, S], np.int32),
          np.asarray([5, 2, 1], np.int32), tables,
          np.zeros(3, np.int32), False)

    # radix hit: prompt_a's first page is committed; the suffix prefills
    # at start = page_size against it, into slot 1
    hit = prompt_a[:page_size] + [8, 8]
    tokens, mask = _right_pad([hit[page_size:], [2]], P)
    tables = np.full((2, max_pages), num_pages, np.int32)
    tables[0, 0] = 0
    tables[0, 1:] = np.arange(2 * max_pages, 3 * max_pages - 1)
    admit(tokens, mask, np.asarray([1, S], np.int32),
          np.asarray([4, 1], np.int32), tables,
          np.asarray([page_size, 0], np.int32), True)

    jcfg = jg.GenerationConfig(gen_size=8,
                               sampling=JaxSampling(do_sample=False),
                               eos_token_id=-1, pad_token_id=256)
    tcfg = tg.GenerationConfig(gen_size=8,
                               sampling=SamplingParams(do_sample=False),
                               eos_token_id=-1, pad_token_id=256)
    jstep = jax.jit(lambda pool, st: jg.decode_step(
        jspec, jblocks, jembed, jln, pool, st, jnp.int32(0), jcfg,
        compute_dtype=jnp.float32))
    for _ in range(6):  # past slot 0's max_new: finished rows ride along
        jpool, jstate, jtok, jem, jfin = jstep(jpool, jstate)
        tpool, tstate, ttok, tem, tfin = tg.decode_step(
            spec, views.blocks, views.embed, views.ln_f, tpool, tstate,
            None, tcfg, compute_dtype=torch.float32,
            paged_decode_fn=make_paged_decode_fn(),
        )
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
        np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
        _check(tstate, jstate, tpool, jpool, num_pages)


@pytest.mark.parametrize("suffix", [False, True])
def test_prefill_filler_rows_drop_like_jax(suffix):
    """A bucket whose filler rows carry out-of-range slot ids (S and
    S + 5, sentinel page tables) between real rows: the static-shape
    prefill drops them as JAX's ``mode="drop"`` scatter does, pool and
    every lane equal to trlx_tpu's, in both prefill variants."""
    spec, jspec = ModelSpec(**SPEC), JaxSpec(**SPEC)
    tree = init_hydra_numpy(spec, num_layers_unfrozen=1, seed=12)
    views = decode_views_from_numpy(tree, spec, 1)
    jblocks, jembed, jln = _jax_views(tree)
    page_size, P = 4, 8
    max_pages = 4
    T, num_pages = max_pages * page_size, S * max_pages
    jpool = jg.init_page_pool(jspec, [1, 1], num_pages, page_size)
    jstate = jg.init_slot_state(S, T, 257, max_pages=max_pages)
    tpool = tg.init_page_pool(spec, [1, 1], num_pages, page_size)
    tstate = tg.init_slot_state(S, T, 257, max_pages)
    tokens, mask = _right_pad([[5, 6, 7], [9], [1, 2, 3, 4, 5], [8, 8]], P)
    slot_ids = np.asarray([S, 2, S + 5, 0], np.int32)
    tables = np.full((4, max_pages), num_pages, np.int32)
    tables[1] = np.arange(max_pages)
    tables[3] = np.arange(max_pages, 2 * max_pages)
    start = np.zeros(4, np.int32)
    if suffix:  # each real row's suffix after one committed page
        start[[1, 3]] = page_size
    max_new = np.asarray([3, 4, 5, 6], np.int32)
    jpool, jstate = jax.jit(
        lambda pool, st, *host: jg.prefill_into_slots(
            jspec, jblocks, jembed, jln, pool, st, *host[:4],
            compute_dtype=jnp.float32, page_tables=host[4],
            page_size=page_size, start=host[5], prefix_context=suffix,
        )
    )(jpool, jstate, tokens, mask, slot_ids, max_new, tables, start)
    lanes = list(tstate)
    tpool, tstate = tg.prefill_into_slots(
        spec, views.blocks, views.embed, views.ln_f, tpool, tstate,
        tokens, mask, slot_ids, max_new, compute_dtype=torch.float32,
        page_tables=tables, page_size=page_size, start=start,
        prefix_context=suffix,
    )
    assert all(a is b for a, b in zip(lanes, tstate))  # updated in place
    _check(tstate, jstate, tpool, jpool, num_pages)
    assert tstate.active.tolist() == [True, False, True]
