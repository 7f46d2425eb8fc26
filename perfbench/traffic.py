"""The one general generator of traffic: every cell's traffic file
(``perfbench/traffic/<name>.json``) is parameters that these functions
read.

Every seed gets the same work in another order. Sizes are the quantiles
of their distribution at n evenly spaced points, then shuffled by the
seed; gaps between arrivals are the quantiles of the exponential; a
popularity draw is a fixed count per item, shuffled. So two seeds differ
in order and in token values, never in how many tokens or requests a run
holds.

A size spec is one of:

- ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
- ``{"dist": "linear", "min": a, "max": b}``: evenly spaced from a to b
- ``{"dist": "fixed", "value": v}``
"""

from statistics import NormalDist
from typing import Dict, List

import numpy as np

def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of one seed (streams do not
    share draws, so adding one leaves the others as they were)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in stream]
    return np.random.default_rng(words)


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """The n sizes of ``spec`` in ascending order (int64)."""
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "linear":
        return np.round(np.linspace(spec["min"], spec["max"], n)).astype(
            np.int64)
    if kind != "lognormal":
        raise ValueError(f"unknown size distribution {kind!r}")
    normal = NormalDist()
    z = np.array([normal.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.round(x), spec["min"], spec["max"]).astype(np.int64)


def sizes(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The n sizes of ``spec``, shuffled by ``rng``."""
    out = quantiles(spec, n)
    rng.shuffle(out)
    return out


def arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Due times (s from 0) of n open-loop arrivals at ``rate`` per
    second: the exponential's quantiles as the gaps, shuffled."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng.shuffle(gaps)
    return np.cumsum(gaps)


def popularity(k: int, exponent: float, n: int,
               rng: np.random.Generator) -> np.ndarray:
    """n picks among k items with Zipf popularity (item i weighs
    1 / (i + 1) ** exponent): each item's count by largest remainders,
    the picks shuffled."""
    w = 1.0 / np.arange(1, k + 1) ** exponent
    share = n * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(-(share - counts), kind="stable")[:rest]] += 1
    picks = np.repeat(np.arange(k), counts)
    rng.shuffle(picks)
    return picks


def token_rows(lengths, vocab: int, rng: np.random.Generator,
               low: int = 0) -> List[np.ndarray]:
    """One row of uniformly drawn token ids in [low, vocab) per length."""
    flat = rng.integers(low, vocab, int(np.sum(lengths)), dtype=np.int64)
    out, at = [], 0
    for n in lengths:
        out.append(flat[at:at + int(n)].astype(np.int32))
        at += int(n)
    return out

