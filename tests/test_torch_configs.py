"""The port's host-side copies against trlx_tpu's: every shipped
``configs/*.yml`` loads to the same nested dict in both packages, the
byte tokenizer encodes, pads and decodes identically, and the page
allocator + radix prefix cache give the same pages, hits, evictions and
free counts under one seeded random admission/harvest trace."""

import pathlib

import numpy as np
import pytest

from trlx_tpu.data.configs import TRLConfig as JaxTRLConfig
from trlx_tpu.serve.paged import RadixCache as JaxRadixCache
from trlx_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.serve.paged import RadixCache
from trlx_tpu_torch.utils.tokenizer import ByteTokenizer, load_tokenizer

CONFIGS = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "configs").glob("*.yml")
)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_configs_load_identically(path):
    mine = TRLConfig.load_yaml(str(path))
    theirs = JaxTRLConfig.load_yaml(str(path))
    assert mine.to_nested_dict() == theirs.to_nested_dict()
    assert TRLConfig.from_dict(mine.to_nested_dict()).to_nested_dict() == \
        mine.to_nested_dict()
    if mine.model.model_spec is not None:
        assert mine.model.resolve_spec() == \
            type(mine.model.resolve_spec())(**vars(
                theirs.model.resolve_spec()))


def test_byte_tokenizer_matches_trlx_tpu():
    mine, theirs = load_tokenizer("byte"), JaxByteTokenizer()
    assert isinstance(mine, ByteTokenizer)
    texts = ["héllo", "", "You answer well.", "\x00\xff"]
    for t in texts:
        assert mine.encode(t) == theirs.encode(t)
        assert mine.decode(mine.encode(t) + [256]) == \
            theirs.decode(theirs.encode(t) + [256])
    for got, want in zip(mine(texts[:3], max_length=8).values(),
                         theirs(texts[:3], max_length=8).values()):
        np.testing.assert_array_equal(got, want)
    assert (mine.eos_token_id, mine.pad_token_id, mine.vocab_size) == (
        theirs.eos_token_id, theirs.pad_token_id, theirs.vocab_size)


@pytest.mark.parametrize("page_size", [2, 4])
def test_radix_cache_trace_matches_trlx_tpu(page_size):
    """Admissions (match -> alloc -> commit, a rollback now and then) and
    harvests (release_all) drawn from one seed, over prompts that share
    prefixes, with a pool small enough to force LRU eviction."""
    rng = np.random.default_rng(page_size)
    caches = [RadixCache(12, page_size), JaxRadixCache(12, page_size)]
    heads = [list(rng.integers(0, 50, 6)) for _ in range(3)]
    live = []  # per admitted request: [pages in each cache]
    for step in range(60):
        if live and (rng.random() < 0.4 or len(live) > 3):
            done = live.pop(int(rng.integers(len(live))))
            for cache, pages in zip(caches, done):
                cache.release_all(pages)
        else:
            toks = heads[int(rng.integers(3))][:int(rng.integers(2, 7))] \
                + list(rng.integers(0, 50, int(rng.integers(1, 4))))
            need = -(-(len(toks) + 2) // page_size)
            got = []
            for cache in caches:
                matched = cache.match(toks)
                fresh = cache.alloc(need - len(matched))
                if fresh is None:
                    cache.release_all(matched)
                    got.append(None)
                    continue
                inserted = cache.commit(toks, matched + fresh)
                if step % 7 == 3:  # a failed prefill
                    cache.rollback(inserted)
                    cache.release_all(matched + fresh)
                    got.append(None)
                    continue
                got.append(matched + fresh)
            assert got[0] == got[1], f"step {step}"
            if got[0] is not None:
                live.append(got)
        for name in ("free_pages", "cached_pages"):
            assert getattr(caches[0], name)() == getattr(caches[1], name)()
        assert caches[0].evicted_pages == caches[1].evicted_pages
    assert caches[0].evicted_pages > 0
