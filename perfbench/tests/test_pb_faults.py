"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, with each fault the cell can have planted in the
program.  The program computes in float32 here, so that a sound run reads
round-off and only the planted fault can fail it against the cell's
limits, which were set at the cell's own size on the chip.  And the
control, the reference in float8 in the program's place, fails one of the
cell's numbers at the tiny size too."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from perfbench.harness import common, serving, traffic
from perfbench.harness.compare import train_gaps
from perfbench.harness.core import execute
from perfbench.harness.weights import make
from perfbench.reference import model as ref

from conftest import TINY, tiny_cell

CPU = torch.device("cpu")
SEED = 4_000_000_007


def run(cell, seconds=2.0):
    return execute(cell, common.benchmark(), SEED, seconds, False, CPU, time.perf_counter())


def failing(result):
    """The numbers over their limits."""
    return [k for k, c in result["checks"].items()
            if c["limit"] is None or not c["value"] <= c["limit"]]


SERVE_CELLS = ["mistral7b.chat", "mistral7b.longdoc"]
TRAIN_CELLS = [("mistral7b.train_s4k", TINY)]


@pytest.fixture(autouse=True)
def float32_program(monkeypatch):
    from perfbench.harness import port

    make_config = port.model_config
    monkeypatch.setattr(port, "model_config", lambda m: dataclasses.replace(
        make_config(m), compute_dtype=torch.float32))


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_sound_serving_run_is_correct(name):
    res = run(tiny_cell(name))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_altered_token_is_caught(name, monkeypatch):
    """Every token the engine picks is altered where it is produced."""
    import tputopo_torch.serving as srv

    pick = srv._select
    vocab = TINY["vocab_size"]
    monkeypatch.setattr(srv, "_select", lambda *a, **k: (pick(*a, **k) + 1) % vocab)
    res = run(tiny_cell(name))
    assert not res["correct"]
    assert "served_gap" in failing(res)


@pytest.mark.parametrize("name, m", TRAIN_CELLS, ids=[n for n, _ in TRAIN_CELLS])
def test_sound_training_run_is_correct(name, m):
    res = run(tiny_cell(name, m))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name, m", TRAIN_CELLS, ids=[n for n, _ in TRAIN_CELLS])
def test_state_left_unchanged_is_caught(name, m, monkeypatch):
    """The step returns its parameters as they were (the moments and the
    counter still advance)."""
    from tputopo_torch import train

    update = train.AdamW.update_

    def no_change(self, grads, state, params):
        keep = [p.clone() for p in train._leaves(params)]
        update(self, grads, state, params)
        for p, k in zip(train._leaves(params), keep):
            p.copy_(k)

    monkeypatch.setattr(train.AdamW, "update_", no_change)
    res = run(tiny_cell(name, m))
    assert not res["correct"]
    assert "change_gap" in failing(res)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    """The step's loss and gradients are the mean over the first half of
    the batch's rows only."""
    from tputopo_torch import train

    grads = train.sharded_loss_and_grads

    def half(plan, params, tokens, config, *a, **k):
        return grads(plan, params, tokens[: tokens.shape[0] // 2], config, *a, **k)

    monkeypatch.setattr(train, "sharded_loss_and_grads", half)
    res = run(tiny_cell("mistral7b.train_s4k", TINY))
    assert not res["correct"]
    assert set(failing(res)) & {"loss_gap", "grad_gap"}


def test_serving_control_fails():
    """The float8 reference's picks, at each position of served sequences,
    lie further below the float32 reference's best than the limit allows."""
    cell = tiny_cell("mistral7b.chat")
    params = make(cell["model"], SEED, CPU)
    rng = np.random.default_rng(0)
    sample = []
    for i in range(4):
        r = serving.Served(traffic.Request(i, 0.0, rng.integers(0, 256, 48), 40))
        r.tokens = rng.integers(0, 256, 40).tolist()
        sample.append(r)
    read = serving.gaps(params, cell["model"], sample, CPU, control=True)
    assert read["control_gap"] > cell["limits"]["served_gap"]


@pytest.mark.parametrize("name, m", TRAIN_CELLS, ids=[n for n, _ in TRAIN_CELLS])
def test_training_control_fails(name, m):
    cell = tiny_cell(name, m)
    mix, opt = cell["traffic_mix"], cell["optimizer"]
    batches = [torch.from_numpy(traffic.train_batch(mix, SEED, m["vocab_size"], i))
               for i in range(3)]
    want = ref.train(make(m, SEED, CPU), batches, m, opt)
    low = ref.train(make(m, SEED, CPU), batches, m, opt, low=True)
    gaps = train_gaps(low, want)
    assert any(gaps[k] > cell["limits"][k] for k in ("loss_gap", "grad_gap", "change_gap"))
