"""The traffic repeats exactly from its seed, and a seed changes the order
of the work, not its amount."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from h100_bench.traffic import Traffic, p90

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_requests(path, seed):
    params = json.loads(path.read_text())
    a, b = Traffic(params, seed), Traffic(params, seed)
    for i in (0, 1, 63, 64, 500):
        ra, rb = a.request(i), b.request(i)
        assert ra == rb
        if ra["image"] is not None:
            assert np.array_equal(a.pixels(i, ra["image"]), b.pixels(i, rb["image"]))
    assert a.warm_up() == b.warm_up()


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seed_changes_order_not_amount(path):
    params = json.loads(path.read_text())
    n = params["block"]
    a, b = Traffic(params, 11), Traffic(params, 2**33 + 7)
    for block in range(3):
        idx = range(block * n, (block + 1) * n)
        sa = [a.sizes(i) for i in idx]
        sb = [b.sizes(i) for i in idx]
        assert sa != sb
        assert Counter(sa) == Counter(sb)  # the same (prompt, output) pairs
        if params.get("images"):
            ia = Counter((a.sizes(i), a.request(i)["image"]) for i in idx)
            assert ia == Counter((b.sizes(i), b.request(i)["image"]) for i in idx)
    assert a.request(5)["prompt"] != b.request(5)["prompt"]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_prompt_lengths_are_the_drawn_sizes(path):
    from h100_bench.reference import tokenizer

    params = json.loads(path.read_text())
    t = Traffic(params, 3)
    for i in range(20):
        r = t.request(i)
        n_prompt, n_out = t.sizes(i)
        assert r["max_tokens"] == n_out
        if r["image"] is None:
            assert len(tokenizer.prompt_ids(r["prompt"])) == n_prompt
        else:
            assert len(r["question"]) == n_prompt
        lo, hi = params["prompt_tokens"]["min"], params["prompt_tokens"]["max"]
        assert lo <= n_prompt <= hi


def test_p90_counts_failures_as_slowest():
    assert p90([float(i) for i in range(1, 11)]) == 9.0
    assert p90([1.0] * 9 + [float("inf")]) == 1.0
    assert p90([1.0] * 8 + [float("inf")] * 2) == float("inf")
