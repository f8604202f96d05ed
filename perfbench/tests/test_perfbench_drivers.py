"""The traffic the drivers make from a seed, on the CPU."""
import json
from collections import Counter

import pytest
import torch

from perfbench import harness, inputs
from perfbench.tests.conftest import ROOT

SEEDS = (0, 2 ** 31 + 11, 3 * 2 ** 32)


def driver(name):
    return harness.load_module(ROOT / "perfbench" / "drivers" / f"{name}.py",
                               "driver_" + name)


def traffic(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json")
                      .read_text())


def test_chunks_follow_the_engine():
    from repro_torch.runtime.serve import Engine
    chat = driver("chat")
    eng = Engine.__new__(Engine)
    eng.prefill_buckets = (512, 64)
    for n in (1, 63, 64, 65, 511, 512, 513, 700, 1536):
        assert chat.chunk_schedule(n, (64, 512)) == eng._chunk_schedule(n)


def test_the_pool_is_one_multiset_in_the_seeds_order():
    chat, t = driver("chat"), traffic("chat-closed-64")
    pools = [chat.Pool(t, 1000, s, "cpu") for s in SEEDS]
    assert len({tuple(p.plen) for p in pools}) == len(SEEDS)
    assert len({tuple(sorted(p.plen)) for p in pools}) == 1
    assert len({tuple(sorted(p.olen)) for p in pools}) == 1
    # every block of 16 takes one length from each sixteenth of the sorted
    # lengths: the same work in any window of a few blocks
    cuts = sorted(pools[0].plen)[::32]
    for p in pools:
        for b in range(0, len(p.plen), 16):
            block = sorted(p.plen[b:b + 16])
            assert all(lo <= x for lo, x in zip(cuts, block))
    assert len({p.mean_out for p in pools}) == 1
    p = pools[0]
    pr, out = t["prompt"], t["output"]
    assert pr["min"] <= min(p.plen) and max(p.plen) <= pr["max"]
    assert out["min"] <= min(p.olen) and max(p.olen) <= out["max"]
    assert max(p.plen) + max(p.olen) <= t["max_len"]
    # the source's medians
    assert sorted(p.plen)[len(p.plen) // 2] == pytest.approx(1020, abs=3)
    assert sorted(p.olen)[len(p.olen) // 2] == pytest.approx(129, abs=1)
    again = chat.Pool(t, 1000, SEEDS[0], "cpu")
    assert (again.take()[0] == p.take()[0]).all()


def test_packed_batches_are_seeded_and_all_differ():
    train, t = driver("train"), traffic("train-packed-2x2048")
    t = dict(t, seq=256)
    f, g = (train.Feed(t, 1000, SEEDS[1], "cpu") for _ in range(2))
    b0, b1 = f.batch(0), f.batch(1)
    assert torch.equal(b0["tokens"], g.batch(0)["tokens"])
    assert b0["tokens"].shape == (2, 256)
    assert torch.equal(b0["tokens"][:, 1:], b0["targets"][:, :-1])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert not torch.equal(b0["tokens"][0], b0["tokens"][1])
    # separators end the documents, of the mix's lengths
    stream = torch.cat([torch.cat([f.batch(k)["tokens"],
                                   f.batch(k)["targets"][:, -1:]], 1)
                        .reshape(-1) for k in range(40)])
    ends = (stream == t["separator"]).nonzero()[:, 0].tolist()
    lengths = [b - a for a, b in zip(ends, ends[1:])]
    assert Counter(lengths).most_common(1)[0][1] >= 1
    assert min(lengths) >= t["doc_min"] and max(lengths) <= t["doc_max"]


def test_lognormal_lengths_and_percentiles():
    n = inputs.lognormal_lengths(101, 96, 0.8, 8, 384)
    assert n == sorted(n) and n[50] == 96 and n[0] >= 8
    pct = harness.percentile
    assert pct([1, 2, 3, 4, 5], 50) == 3
    assert pct(list(range(101)), 95) == pytest.approx(95.0)
    assert pct([1, 2, float("inf")], 90) == float("inf")
    assert pct([1, 2, 3, float("inf")], 50) == 2.5
