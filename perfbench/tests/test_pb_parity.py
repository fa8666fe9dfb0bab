"""The plain reference against the program at tiny sizes, with the
program computing in float32, for each driver's path: a dense and an MoE
forward, the serving engine's prefill and cached decode, and one train
step.  The reference's semantics match the program's before chip time is
spent on them."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import serving, traffic
from perfbench.harness.compare import train_gaps
from perfbench.harness.port import model_config
from perfbench.harness.weights import flat, make
from perfbench.reference import model as ref

from conftest import TINY, TINY_MOE

CPU = torch.device("cpu")


def f32(m):
    return dataclasses.replace(model_config(m), compute_dtype=torch.float32)


@pytest.mark.parametrize("m", [TINY, TINY_MOE], ids=["dense", "moe"])
def test_forward(m):
    import tputopo_torch as tt

    params = make(m, 7, CPU)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, m["vocab_size"], (2, 24)))
    got = tt.forward(params, tokens, f32(m))
    for b in range(2):
        want = ref.logits_at(params, tokens[b], m, torch.arange(24), seated=True)
        assert (got[b] - want).abs().max() < 2e-4


@pytest.mark.parametrize("m", [TINY, TINY_MOE], ids=["dense", "moe"])
def test_engine_prefill_and_cached_decode(m):
    """Whole-bucket and chunked admissions, then decode through the cache:
    every served token is the reference's best at its position."""
    from perfbench.harness.port import engine_class

    params = make(m, 11, CPU)
    got = {}
    eng = engine_class()(params, f32(m), slots=3, max_len=96, prompt_pad=(16, 48),
                         prefill_chunk=16,
                         on_tokens=lambda rid, t: got.setdefault(rid, []).extend(t))
    rng = np.random.default_rng(1)
    reqs = {}
    for n, new in ((5, 9), (40, 12), (16, 7), (33, 20)):
        prompt = rng.integers(0, m["vocab_size"], n)
        reqs[eng.submit(prompt, new)] = (prompt, new)
    eng.run()
    sample = []
    for rid, (prompt, new) in reqs.items():
        r = serving.Served(traffic.Request(rid, 0.0, prompt, new))
        r.tokens = got[rid]
        assert len(r.tokens) == new
        sample.append(r)
    read = serving.gaps(params, m, sample, CPU)
    assert read["compared_tokens"] == sum(new for _, new in reqs.values())
    assert read["served_gap"] < 1e-4


@pytest.mark.parametrize("m", [TINY, TINY_MOE], ids=["dense", "moe"])
def test_train_step(m):
    from tputopo_torch.train import TrainState, make_optimizer, train_step

    opt = {"lr": 3e-4, "weight_decay": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8}
    batch = torch.from_numpy(np.random.default_rng(2).integers(
        0, m["vocab_size"], (1 if "num_local_experts" in m else 2, 32)))
    params = make(m, 5, CPU)
    state = TrainState(params=params, opt_state=make_optimizer(3e-4).init(params),
                       step=torch.zeros((), dtype=torch.int32))
    state, loss = train_step(state, batch, f32(m))
    start = flat(make(m, 5, CPU))
    prog = {"loss": [float(loss)],
            "grad_norm": {k: float(v.norm()) / 0.1 for k, v in flat(state.opt_state.mu).items()},
            "change_norm": {k: float((v - start[k]).norm()) for k, v in flat(state.params).items()}}
    want = ref.train(make(m, 5, CPU), [batch], m, opt)
    gaps = train_gaps(prog, want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-4
