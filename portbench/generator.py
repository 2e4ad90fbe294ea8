"""The one generator every traffic mix is read by.

A mix (``traffic/<name>.json``) holds all its parameters; the generator
turns them and ``--seed`` into the run's inputs. The seed orders and fills
the inputs, and does not choose their sizes: every seed gets the same set
of lengths in blocks of ``block`` requests (the quantiles (i + 1/2) / block
of each length's distribution, shuffled within the block), so any
prefix of a run's requests has nearly the same lengths whatever the seed,
and runs with different seeds do the same work in another order.

Distributions: ``{"dist": "uniform", "min": a, "max": b}`` (integers a..b)
and ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
(m exp(s z), rounded and clipped to a..b).
"""

from __future__ import annotations

import math
import statistics

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The run's generator for one purpose (``stream``) of the seed; any
    whole number seeds it, beyond 32 bits too."""
    return np.random.Generator(np.random.PCG64([seed & SEED_MASK, stream]))


def quantile(spec: dict, p: float) -> int:
    """The ``p`` quantile (0 < p < 1) of a length distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return lo + min(int(p * (hi - lo + 1)), hi - lo)
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(p)
        x = spec["median"] * math.exp(spec["sigma"] * z)
        return min(max(int(round(x)), lo), hi)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def block_lengths(spec: dict, block: int) -> np.ndarray:
    return np.array([quantile(spec, (i + 0.5) / block) for i in
                     range(block)], np.int64)


def request_lengths(mix: dict, seed: int, count: int) -> np.ndarray:
    """(count, 2) prompt and output lengths: whole blocks of the mix's
    quantile grids, each column shuffled within its block by the seed."""
    block = int(mix["block"])
    g = rng(seed, 1)
    grids = [block_lengths(mix["prompt"], block),
             block_lengths(mix["output"], block)]
    blocks = -(-count // block)
    cols = [np.concatenate([g.permutation(grid) for _ in range(blocks)])
            for grid in grids]
    return np.stack(cols, axis=1)[:count]


def request_pool(mix: dict, seed: int, vocab: int) -> list:
    """The closed loop's requests in sending order: (prompt int32 array,
    output length), prompt tokens drawn uniformly from the vocabulary."""
    lengths = request_lengths(mix, seed, int(mix["pool"]))
    g = rng(seed, 2)
    flat = g.integers(0, vocab, int(lengths[:, 0].sum()), dtype=np.int32)
    cuts = np.cumsum(lengths[:, 0])[:-1]
    return [(p, int(n)) for p, n in zip(np.split(flat, cuts),
                                        lengths[:, 1])]


def token_batches(mix: dict, seed: int, vocab: int):
    """An endless stream of {"tokens": (batch, seq) int64} host batches,
    uniform over the vocabulary."""
    g = rng(seed, 3)
    shape = (int(mix["batch"]), int(mix["seq"]))
    while True:
        yield {"tokens": g.integers(0, vocab, shape, dtype=np.int64)}


def image_records(mix: dict, seed: int, chunk: int = 128):
    """The mix's stored images and labels in chunks of ``chunk`` records:
    (uint8 (n, h, w, c) pixels, int32 (n,) labels)."""
    g = rng(seed, 4)
    n, shape = int(mix["records"]), tuple(mix["stored"])
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        yield (g.integers(0, 256, (m,) + shape, dtype=np.uint8),
               g.integers(0, int(mix["classes"]), m).astype(np.int32))
