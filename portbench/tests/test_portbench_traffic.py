"""The generator: deterministic in the seed, within the mix's ranges, and
the same set of lengths for every seed."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import generator

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
BIG_SEED = 2**31 + 12345  # beyond 32 signed bits, as a check's seeds are


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat_closed64", "rag_closed64"])
def test_serving_mix_is_deterministic_and_in_range(name):
    m = mix(name)
    a = generator.request_pool(m, BIG_SEED, 50257)
    b = generator.request_pool(m, BIG_SEED, 50257)
    assert len(a) == m["pool"]
    assert all(np.array_equal(pa, pb) and na == nb
               for (pa, na), (pb, nb) in zip(a, b))
    for prompt, n_out in a:
        assert m["prompt"]["min"] <= len(prompt) <= m["prompt"]["max"]
        assert m["output"]["min"] <= n_out <= m["output"]["max"]
        assert len(prompt) + n_out <= 1024  # every request fits n_ctx
        assert prompt.dtype == np.int32
        assert 0 <= prompt.min() and prompt.max() < 50257
    c = generator.request_pool(m, BIG_SEED + 1, 50257)
    assert any(not np.array_equal(pa, pc) for (pa, _), (pc, _) in
               zip(a, c))


@pytest.mark.parametrize("name", ["chat_closed64", "rag_closed64"])
def test_every_seed_gets_the_same_lengths_in_each_block(name):
    m = mix(name)
    block = m["block"]
    runs = [generator.request_lengths(m, s, 4 * block) for s in (1, 2,
                                                                  BIG_SEED)]
    for r in runs[1:]:
        assert not np.array_equal(r, runs[0])  # another order
        for k in range(4):
            for col in (0, 1):
                got = collections.Counter(r[k * block:(k + 1) * block, col])
                want = collections.Counter(
                    runs[0][k * block:(k + 1) * block, col])
                assert got == want


def test_lognormal_quantiles_have_the_stated_median():
    spec = {"dist": "lognormal", "median": 256, "sigma": 0.6, "min": 32,
            "max": 768}
    assert generator.quantile(spec, 0.5) == 256
    grid = generator.block_lengths(spec, 64)
    assert grid.min() >= 32 and grid.max() <= 768
    assert np.all(np.diff(grid) >= 0)


def test_uniform_quantiles_cover_the_range():
    spec = {"dist": "uniform", "min": 8, "max": 32}
    grid = generator.block_lengths(spec, 25)
    assert sorted(set(grid.tolist())) == list(range(8, 33))


def test_token_batches_and_records_are_deterministic():
    m = mix("lm_tokens_b12s1024")
    a, b = (generator.token_batches(m, BIG_SEED, 50257) for _ in range(2))
    for _ in range(3):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.shape == (12, 1024) and np.array_equal(x, y)
        assert x.max() < 50257
    small = {"records": 5, "stored": [4, 4, 3], "classes": 10}
    r1 = list(generator.image_records(small, 7, chunk=2))
    r2 = list(generator.image_records(small, 7, chunk=2))
    assert [len(p) for p, _ in r1] == [2, 2, 1]
    assert all(np.array_equal(p1, p2) and np.array_equal(l1, l2)
               for (p1, l1), (p2, l2) in zip(r1, r2))


@pytest.mark.parametrize("name,prompt_mean,output_mean", [
    ("chat_closed64", 161.31, 337.99),
])
def test_chat_lengths_keep_their_published_means(name, prompt_mean,
                                                 output_mean):
    # the mix's source gives means: its 64-quantile grid keeps them to 1%
    m = mix(name)
    for key, want in (("prompt", prompt_mean), ("output", output_mean)):
        got = generator.block_lengths(m[key], int(m["block"])).mean()
        assert abs(got - want) <= 0.01 * want, (key, got)


@pytest.mark.parametrize("name,prompt_median,output_median", [
    ("rag_closed64", 750, 13),
])
def test_long_prompt_lengths_keep_their_published_medians(
        name, prompt_median, output_median):
    # the source gives medians (the prompt's halved, as `reduced` says)
    m = mix(name)
    for key, want in (("prompt", prompt_median), ("output", output_median)):
        grid = generator.block_lengths(m[key], int(m["block"]))
        assert np.median(grid) == want, key
