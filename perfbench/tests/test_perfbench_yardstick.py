"""The frozen byte and FLOP counts against hand counts."""

import numpy as np
import pytest

from perfbench import yardstick


def test_flash_bounds_by_hand():
    # B 2, T 4, one head of 8, bf16, every causal pair: 10 a row
    out = yardstick.flash_bounds(2, 4, 1, 8, 2, peak_flops=1.0,
                                 hbm_bytes_per_s=1.0)
    n, mask, row, macs = 2 * 4 * 8, 4 * 2 * 4, 4 * 2 * 4, 2 * 10 * 8
    assert out["flash_fwd"][2:] == (4 * n * 2 + mask + row, 4 * macs)
    assert out["flash_bwd_dq"][2:] == (6 * n * 2 + mask + 2 * row, 6 * macs)
    assert out["flash_bwd_dkv"][2:] == (6 * n * 2 + mask + 2 * row, 8 * macs)
    assert out["flash_fwd"][0] == max(out["flash_fwd"][2:])


def test_flash_bounds_second_shape_and_key_mask():
    # one row of 3 with its first key padded: pairs with a real key 0+1+2
    mask = np.array([[0, 1, 1]])
    assert yardstick.causal_key_macs(mask, 3, 1, 1) == 3
    assert yardstick.causal_key_macs([2], 3, 1, 1, left_padded=True) == 3
    assert yardstick.causal_key_macs([2], 3, 1, 1) == 1 + 2 + 2
    out = yardstick.flash_bounds(1, 3, 2, 4, 4, causal=False,
                                 peak_flops=1e12, hbm_bytes_per_s=1e9)
    macs = 1 * 2 * 9 * 4
    assert out["flash_fwd"][3] == 4 * macs
    assert out["flash_fwd"][1] == "bytes"


def test_paged_bound_by_hand():
    secs, bound, nbytes, flops = yardstick.paged_bound(
        2, 2, 1, 4, 2, 3, 3, 2, peak_flops=1.0, hbm_bytes_per_s=1.0)
    kv = 2 * 3 * 2 * 1 * 4 * 2
    io = 2 * 2 * 2 * 4 * 2 + 2 * 3 * 4 + 2 * 3 * 2 * 4
    assert (nbytes, flops) == (kv + io, 4 * 2 * 4 * 3 * 2)
    assert secs == max(nbytes, flops) and bound == "bytes"


@pytest.mark.parametrize("n", [1, 3])
def test_model_flops_by_hand(n):
    spec = {"arch": "gptj", "d_model": 2, "d_ff": 8, "n_layer": 1,
            "n_head": 1, "vocab_size": 5}
    per_token = 2 * (4 * 2 * 2 + 2 * 2 * 8)
    attention = 4 * 2 * (n * (n + 1) // 2)
    layers = range(1)
    assert yardstick.forward_flops(spec, layers, [n]) == \
        per_token * n + attention
    assert yardstick.prefill_flops(spec, layers, n) == \
        per_token * n + attention + 2 * 2 * 5
    # decoding one token after n: every block once, n + 1 keys, the head
    assert yardstick.decode_flops(spec, layers, n, 1) == \
        per_token + 4 * 2 * (n + 1) + 2 * 2 * 5
    assert yardstick.head_flops(2, 5) == 2 * (2 * 4 + 4 * 5)
    # n more tokens after 4 cached: n tokens through the block, each
    # attending to the 4 cached keys and causally among themselves
    assert yardstick.prefill_flops(spec, layers, 4 + n, cached=4) == \
        per_token * n + 4 * 2 * (4 * n + n * (n + 1) // 2) + 2 * 2 * 5
