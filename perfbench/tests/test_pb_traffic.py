"""The traffic generator: deterministic per seed, the stated distributions,
and the same work for every seed."""

import statistics

import numpy as np
import pytest

from perfbench.harness import traffic
from perfbench.harness.common import load_json, BENCH

CHAT = load_json(BENCH / "traffic" / "chat.json")
LONGDOC = load_json(BENCH / "traffic" / "longdoc.json")
SEED = 2 ** 33 + 12345     # past 32 bits, as the driver's are


def test_same_seed_same_requests():
    a = traffic.requests(CHAT, SEED, 32768, 45)
    b = traffic.requests(CHAT, SEED, 32768, 45)
    assert [(r.due, r.max_new, r.prompt.tolist()) for r in a] == \
           [(r.due, r.max_new, r.prompt.tolist()) for r in b]


def test_other_seed_same_work_same_order():
    """The seed draws the token ids only: lengths, answers and arrival
    times come in one order for every seed."""
    for mix in (CHAT, LONGDOC):
        a = traffic.requests(mix, SEED, 32768, 45)
        b = traffic.requests(mix, SEED + 1, 32768, 45)
        assert [(r.due, len(r.prompt), r.max_new) for r in a] == \
               [(r.due, len(r.prompt), r.max_new) for r in b]
        assert any((x.prompt != y.prompt).any() for x, y in zip(a, b))


def test_lengths_stratified_in_blocks():
    """Each run of ``block`` requests takes one length from every stratum
    of neighbouring ranks."""
    for mix in (CHAT, LONGDOC):
        reqs = traffic.requests(mix, SEED, 32768, 45)
        k = mix["block"]
        n = len(reqs) - len(reqs) % k
        for key, dist in ((lambda r: len(r.prompt), mix["prompt"]),
                          (lambda r: r.max_new, mix["output"])):
            strata = np.array_split(traffic.quantiles(dist, len(reqs)), k)
            for b in range(0, n, k):
                got = sorted(key(r) for r in reqs[b:b + k])
                assert all(lo <= x <= hi for x, lo, hi in
                           zip(got, (s[0] for s in strata), (s[-1] for s in strata)))


@pytest.mark.parametrize("seconds", [10, 45, 51])
def test_poisson_count_and_window(seconds):
    reqs = traffic.requests(CHAT, SEED, 32768, seconds)
    rate = CHAT["arrival"]["rate"]
    assert len(reqs) == round(rate * seconds)
    due = [r.due for r in reqs]
    assert due == sorted(due) and due[0] == 0.0 and due[-1] < seconds
    # the gaps are the exponential's quantiles: their spread is its own
    gaps = np.diff(due)
    assert statistics.pstdev(gaps) / statistics.mean(gaps) > 0.8


def test_lognormal_lengths():
    reqs = traffic.requests(CHAT, SEED, 32768, 200)
    p = [len(r.prompt) for r in reqs]
    o = [r.max_new for r in reqs]
    assert min(p) >= 16 and max(p) <= 1024 and min(o) >= 16 and max(o) <= 512
    assert abs(statistics.median(p) - 256) <= 3
    assert abs(statistics.median(o) - 64) <= 2


def test_uniform_backlog():
    reqs = traffic.requests(LONGDOC, SEED, 32768, 45)
    p = [len(r.prompt) for r in reqs]
    assert len(reqs) == LONGDOC["arrival"]["count"]
    assert all(r.due == 0 for r in reqs)
    assert 1536 <= min(p) and max(p) <= 6144
    assert abs(statistics.mean(p) - (1536 + 6144) / 2) < 30


def test_token_ids_in_vocab():
    reqs = traffic.requests(CHAT, SEED, 1000, 20)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 1000


def test_train_batches():
    mix = {"batch": 4, "seq": 64}
    a = traffic.train_batch(mix, SEED, 32768, 0)
    assert a.shape == (4, 64) and a.dtype == np.int64
    assert (a == traffic.train_batch(mix, SEED, 32768, 0)).all()
    b = traffic.train_batch(mix, SEED, 32768, 1)
    assert not (a == b).all()
    assert len({tuple(r) for r in np.concatenate([a, b])}) == 8   # every row differs
