"""The port's host C++ data path (trlx_tpu_torch.native,
trlx_tpu_torch/csrc/hostdata.cpp) against trlx_tpu.native and the Python
loops on the CPU (tests/test_native.py is the reference's own file):
``byte_tokenize_pad`` and ``pad_collate`` equal trlx_tpu's library and
the loops, threaded or not; the byte tokenizer's 64-text path and the
ILQL store's loader give the same batches with the library on and off,
and the same as trlx_tpu's; the library builds under ``build/host/`` with
a source hash in its name; ``TRLX_TPU_NO_NATIVE`` keeps the Python
path."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from trlx_tpu import native as jax_native
from trlx_tpu.pipeline.offline_pipeline import \
    OfflineRolloutStorage as JaxStore
from trlx_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from trlx_tpu_torch import native
from trlx_tpu_torch.pipeline.offline_pipeline import OfflineRolloutStorage
from trlx_tpu_torch.utils.tokenizer import ByteTokenizer

REPO = pathlib.Path(__file__).resolve().parent.parent

TEXTS = ["hello", "a", "", "longer text éè", "x" * 40, "ünï ☃ ok",
         "\x00nul", "tab\tand\nnewline"]


def python_tokenize_pad(texts, max_len, pad_id, pad_left):
    ids = np.full((len(texts), max_len), pad_id, np.int32)
    mask = np.zeros((len(texts), max_len), np.int32)
    for i, t in enumerate(texts):
        e = list(t.encode("utf-8"))[:max_len]
        at = max_len - len(e) if pad_left else 0
        ids[i, at:at + len(e)] = e
        mask[i, at:at + len(e)] = 1
    return ids, mask


def ilql_rows(seed, lengths):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 257, size=n).astype(np.int32) for n in lengths]
    masks = [np.ones(n, np.int32) for n in lengths]
    for m in masks:
        m[-1] = 0  # ILQL zeroes the terminal position
    rewards = [rng.normal(size=max(n - 1, 0)).astype(np.float32)
               for n in lengths]
    return rows, masks, rewards


def test_library_builds_under_build_host_with_a_source_hash():
    assert native.available()
    path = native.library_path()
    assert path.parent == REPO / "build" / "host"
    assert path.exists() and path.name.startswith("libhostdata-")
    assert native.BUILD_INFO["path"] == str(path)
    assert native.SOURCE == REPO / "trlx_tpu_torch" / "csrc" / "hostdata.cpp"


@pytest.mark.parametrize("pad_left", [True, False])
@pytest.mark.parametrize("max_len", [1, 6, 16, 64])
@pytest.mark.parametrize("threads", [0, 1, 3])
def test_byte_tokenize_pad_equals_trlx_tpu_and_python(pad_left, max_len,
                                                      threads):
    ids, mask = native.byte_tokenize_pad(TEXTS, max_len, 256,
                                         pad_left=pad_left, threads=threads)
    want_ids, want_mask = python_tokenize_pad(TEXTS, max_len, 256, pad_left)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    jax_ids, jax_mask = jax_native.byte_tokenize_pad(
        TEXTS, max_len, 256, pad_left=pad_left, threads=threads)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(mask, jax_mask)


@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("with_rewards", [True, False])
@pytest.mark.parametrize("threads", [0, 2])
def test_pad_collate_equals_trlx_tpu_and_python(with_masks, with_rewards,
                                                threads):
    rows, masks, rewards = ilql_rows(0, [3, 7, 1, 5, 12, 2])
    maxlen, pad = 12, 99
    masks = masks if with_masks else None
    rewards = rewards if with_rewards else None
    ids, mask, rw = native.pad_collate(rows, masks, rewards, maxlen, pad,
                                       threads=threads)
    jax_ids, jax_mask, jax_rw = jax_native.pad_collate(
        rows, masks, rewards, maxlen, pad, threads=threads)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(mask, jax_mask)
    if with_rewards:
        np.testing.assert_array_equal(rw, jax_rw)
    else:
        assert rw is None and jax_rw is None
    for i, r in enumerate(rows):
        n = len(r)
        np.testing.assert_array_equal(ids[i, :n], r)
        assert (ids[i, n:] == pad).all() and (mask[i, n:] == 0).all()
        np.testing.assert_array_equal(
            mask[i, :n], masks[i] if with_masks else np.ones(n, np.int32))
        if with_rewards:
            np.testing.assert_array_equal(rw[i, :n - 1], rewards[i])
            assert (rw[i, max(n - 1, 0):] == 0).all()


def test_pad_collate_refuses_short_rows_as_trlx_tpu_does():
    rows, masks, rewards = ilql_rows(1, [4, 6])
    for bad in ([masks[0], masks[1][:-1]], None):
        kwargs = {"masks": bad or masks,
                  "rewards": None if bad else [rewards[0], rewards[1][:-2]]}
        with pytest.raises(ValueError) as ours:
            native.pad_collate(rows, kwargs["masks"], kwargs["rewards"], 8, 0)
        with pytest.raises(ValueError) as theirs:
            jax_native.pad_collate(rows, kwargs["masks"], kwargs["rewards"],
                                   8, 0)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n", [63, 64, 200])
@pytest.mark.parametrize("max_length", [None, 12])
def test_byte_tokenizer_native_on_and_off_equal_trlx_tpu(monkeypatch, n,
                                                         max_length):
    texts = [f"prompt {i} " + "é" * (i % 7) for i in range(n)]
    tok = ByteTokenizer()
    before = native.CALLS["byte_tokenize_pad"]
    fast = tok(texts, max_length=max_length)
    went_native = native.CALLS["byte_tokenize_pad"] - before
    assert went_native == (1 if n >= 64 else 0)
    want = JaxByteTokenizer()(texts, max_length=max_length)
    monkeypatch.setattr(native, "available", lambda: False)
    slow = tok(texts, max_length=max_length)
    assert native.CALLS["byte_tokenize_pad"] - before == went_native
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(fast[key], slow[key])
        np.testing.assert_array_equal(fast[key], want[key])
        assert fast[key].dtype == slow[key].dtype == np.int32


@pytest.mark.parametrize("pad_to_multiple", [1, 8])
def test_offline_loader_native_on_and_off_equal_trlx_tpu(monkeypatch,
                                                         pad_to_multiple):
    rows, masks, rewards = ilql_rows(2, [4, 6, 3, 8, 5, 130, 77])
    args = ([r.tolist() for r in rows], [m.tolist() for m in masks],
            [r.tolist() for r in rewards])
    kwargs = dict(batch_size=3, shuffle=True, seed=5, eos_token_id=7,
                  pad_to_multiple=pad_to_multiple)
    before = native.CALLS["pad_collate"]
    fast = list(OfflineRolloutStorage(*args).create_loader(**kwargs))
    assert native.CALLS["pad_collate"] - before == len(fast) == 3
    want = list(JaxStore(*args).create_loader(**kwargs))
    monkeypatch.setattr(native, "available", lambda: False)
    slow = list(OfflineRolloutStorage(*args).create_loader(**kwargs))
    assert native.CALLS["pad_collate"] - before == 3
    for a, b, c in zip(fast, slow, want):
        for field in ("input_ids", "attention_mask", "rewards"):
            x, y, z = (getattr(a, field), getattr(b, field),
                       getattr(c, field))
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, np.asarray(z))
            assert x.dtype == y.dtype
        assert a.input_ids.shape[1] % pad_to_multiple == 0


def test_no_native_switch_keeps_the_python_path():
    probe = ("import json; from trlx_tpu_torch import native; "
             "from trlx_tpu_torch.utils.tokenizer import ByteTokenizer; "
             "out = ByteTokenizer()(['t%d' % i for i in range(100)], "
             "max_length=8); print(json.dumps([native.available(), "
             "native.CALLS, list(out['input_ids'].shape), "
             "native.BUILD_INFO]))")
    out = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=120, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO),
             "TRLX_TPU_NO_NATIVE": "1"})
    assert out.returncode == 0, out.stderr
    available, calls, shape, info = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert available is False and info == {}
    assert calls == {"byte_tokenize_pad": 0, "pad_collate": 0}
    assert shape == [100, 8]


def test_native_cache_variable_decides_the_build_directory(tmp_path,
                                                           monkeypatch):
    """``$TRLX_TPU_NATIVE_CACHE`` (trlx_tpu.native's variable) names the
    build directory, so a read-only checkout still gets the library; unset,
    the library builds under ``build/host/``."""
    monkeypatch.delenv(native.CACHE_ENV, raising=False)
    assert native.build_dir() == REPO / "build" / "host"
    cache = tmp_path / "native cache"
    monkeypatch.setenv(native.CACHE_ENV, str(cache))
    assert native.library_path().parent == cache
    probe = ("import json; from trlx_tpu_torch import native; "
             "ids, _ = native.byte_tokenize_pad(['ab'], 4, 256); "
             "print(json.dumps([native.available(), native.BUILD_INFO, "
             "ids.tolist()]))")
    out = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=120, cwd=str(REPO),
        env={**os.environ, "PYTHONPATH": str(REPO),
             native.CACHE_ENV: str(cache)})
    assert out.returncode == 0, out.stderr
    available, info, ids = json.loads(out.stdout.strip().splitlines()[-1])
    assert available is True
    built = pathlib.Path(info["path"])
    assert built.parent == cache and built.exists()
    assert built.name == native.library_path().name
    assert ids == [[256, 256, 97, 98]]
