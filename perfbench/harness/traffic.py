"""The one traffic generator: it reads a mix's parameters (a
``traffic/<name>.json`` file) and the run's seed.

Every seed gets the same requests in the same order: the n lengths of a
distribution are its n mid-quantiles, and the n gaps between arrivals are
the exponential distribution's, each put in one order fixed for the mix.
So the work of a run, and when it comes, is fixed by the mix, and the seed
draws only the token ids (and, elsewhere, the weights).  Runs with
different seeds then differ by as little as runs of one seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from perfbench.harness.common import sub_seed

_NORMAL = NormalDist()


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n mid-quantiles ((i + 0.5) / n) of a length distribution, as
    whole numbers clipped to [min, max].  Kinds: ``lognormal`` (``median``,
    ``sigma``) and ``uniform``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["kind"]
    if kind == "lognormal":
        x = dist["median"] * np.exp(dist["sigma"] * np.array(
            [_NORMAL.inv_cdf(p) for p in u]))
    elif kind == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    lo, hi = dist.get("min", 1), dist.get("max", x.max())
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _lengths(rng, dist: dict, n: int, block: int) -> np.ndarray:
    """The n mid-quantiles, stratified: the sorted quantiles fall into
    ``block`` strata of neighbouring ranks, and each run of ``block``
    requests takes one length from every stratum (which one, and their
    order in the run, drawn from ``rng``), so every run of requests spans
    the whole distribution."""
    q = quantiles(dist, n)
    strata = [rng.permutation(s) for s in np.array_split(q, block)]
    out = []
    for b in range(-(-n // block)):
        run = [s[b] for s in strata if b < len(s)]
        out.extend(rng.permutation(run))
    return np.asarray(out, dtype=np.int64)


@dataclass
class Request:
    index: int
    due: float            # seconds after the window opens (0 for a backlog)
    prompt: np.ndarray    # int64 token ids
    max_new: int


def requests(mix: dict, seed: int, vocab: int, seconds: float) -> list[Request]:
    """The requests of one run, in the order they are due.

    ``arrival`` ``poisson``: ``rate`` x ``seconds`` requests whose gaps are the
    exponential mid-quantiles at ``rate``, scaled so the requests fill the
    window.  ``backlog``: ``count`` requests, all due at 0.  The lengths are
    stratified over runs of ``block`` requests (:func:`_lengths`).  Gaps
    and lengths take one order for every seed; the seed draws the token
    ids."""
    arrival = mix["arrival"]
    if arrival["kind"] == "poisson":
        n = max(1, round(arrival["rate"] * seconds))
    elif arrival["kind"] == "backlog":
        n = int(arrival["count"])
    else:
        raise ValueError(f"unknown arrival kind {arrival['kind']!r}")
    order = np.random.default_rng(1)
    prompts = _lengths(order, mix["prompt"], n, mix["block"])
    outputs = _lengths(order, mix["output"], n, mix["block"])
    if arrival["kind"] == "poisson":
        u = (np.arange(n) + 0.5) / n
        gaps = np.random.default_rng(0).permutation(-np.log1p(-u))
        due = np.cumsum(gaps) - gaps[0]
        due *= (seconds * (n - 1) / n) / max(due[-1], 1e-9)
    else:
        due = np.zeros(n)
    ids = np.random.default_rng(sub_seed(seed, 2))
    return [Request(i, float(due[i]), ids.integers(0, vocab, int(prompts[i])),
                    int(outputs[i])) for i in range(n)]


def train_batch(mix: dict, seed: int, vocab: int, step: int) -> np.ndarray:
    """Step ``step``'s token batch [batch, seq], uniform ids: every step's
    rows differ."""
    rng = np.random.default_rng(sub_seed(seed, 3, step))
    return rng.integers(0, vocab, (mix["batch"], mix["seq"]), dtype=np.int64)
