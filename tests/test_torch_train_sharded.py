"""The port's DP x TP sharded training step (tputopo_torch.train) on 4 gloo
ranks against the JAX package's SINGLE-device ``train_step`` from the same
converted state and tokens, on the tiny f32 config of
``tests/test_workloads.py`` (4 q heads, 2 kv heads)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import run_ranks, world_of_one
from tputopo.workloads import model as jm
from tputopo.workloads import train as jt
from tputopo_torch import model as tm
from tputopo_torch import sharding as sh
from tputopo_torch import train as tr

torch.set_num_threads(1)

TINY = jm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=64, max_seq=32, compute_dtype=jnp.float32)
TTINY = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                       n_kv_heads=2, d_ff=64, max_seq=32, compute_dtype=torch.float32)
LR = 1e-2
# The reference's own tolerances for the sharded step against the
# single-device one (tests/test_workloads.py:116-137): the loss at rel
# 2e-4, the updated params at rtol 2e-3 / atol 2e-5.
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5
# The whole model's forward tolerance (tests/test_attention.py:61).
LOGIT_TOL = 2e-4

CASES = {
    # dp 2 x tp 2: kv heads 2 split over tp 2, one per rank
    "dp2tp2": {"axes": {"dp": 2, "tp": 2}, "accum": 1, "logits": True},
    # tp 4 does not divide the 2 kv heads: wk/wv replicated over tp
    "tp4": {"axes": {"dp": 1, "tp": 4}, "accum": 1, "logits": True},
    # gradient accumulation on top of dp: still the full-batch step
    "dp2tp2_accum2": {"axes": {"dp": 2, "tp": 2}, "accum": 2},
    "dp4": {"axes": {"dp": 4, "tp": 1}, "accum": 1},
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX single-device reference and one 4-rank run of every case."""
    tokens = np.random.default_rng(0).integers(0, 64, (4, 16))
    state = jt.make_train_state(TINY, jax.random.key(2), lr=LR)
    params0 = _flat(jax.device_get(state.params))
    ref_loss = float(jt.loss_fn(state.params, jnp.asarray(tokens), TINY))
    ref_logits = np.asarray(jm.forward(state.params, jnp.asarray(tokens), TINY))
    new, loss = jax.jit(lambda s, t: jt.train_step(s, t, TINY, lr=LR))(
        state, jnp.asarray(tokens))
    d = tmp_path_factory.mktemp("train_sharded")
    np.savez(d / "inputs.npz", tokens=tokens, **{f"p.{k}": v for k, v in params0.items()})
    cases = [dict(name=n, **c) for n, c in CASES.items()]
    ranks = run_ranks("train_sharded", 4, d, {"cases": cases, "lr": LR})
    return {"ref_loss": ref_loss, "ref_step_loss": float(loss),
            "ref_params": _flat(jax.device_get(new.params)), "ref_logits": ref_logits,
            "params0": params0, "tokens": tokens, "ranks": ranks,
            "arrays": dict(np.load(d / "rank0.npz"))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_jax_single_device(runs, case):
    for r in runs["ranks"]:
        assert r[case]["loss"] == pytest.approx(runs["ref_loss"], rel=LOSS_REL)
        assert r[case]["step"] == 1
    for name, ref in runs["ref_params"].items():
        np.testing.assert_allclose(runs["arrays"][f"{case}.{name}"], ref,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["dp2tp2", "tp4"])
def test_tensor_parallel_forward_matches_jax(runs, case):
    np.testing.assert_allclose(runs["arrays"][f"{case}.logits"], runs["ref_logits"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_local_shards_follow_the_megatron_layout(runs):
    L, D, H = TINY.n_layers, TINY.d_model, TINY.n_heads * TINY.head_dim
    KV = TINY.n_kv_heads * TINY.head_dim
    for r in runs["ranks"]:
        assert r["dp2tp2"]["wq_local"] == [L, D, H // 2]
        assert r["dp2tp2"]["wk_local"] == [L, D, KV // 2]
        assert r["tp4"]["wq_local"] == [L, D, H // 4]
        assert r["tp4"]["wk_local"] == [L, D, KV]  # replicated: 2 kv heads, tp 4
        assert r["dp4"]["wq_local"] == [L, D, H]


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_then_gather_is_the_identity(runs, case):
    assert all(r[case]["roundtrip"] for r in runs["ranks"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_sharded_state_shards_are_slices_of_make_train_state(runs, case):
    assert all(r[case]["shards_equal"] for r in runs["ranks"])


def test_world_of_one_sharded_step_equals_train_step_exactly():
    """At dp = tp = 1 the sharded step is train_step bit for bit: the same
    unsharded loss, a world-1 all-reduce, a divide by 1."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 16)))
    ref = tr.make_train_state(TTINY, 3, lr=LR, device="cpu")
    ref, ref_loss = tr.train_step(ref, tokens, TTINY, lr=LR)
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        state = tr.make_sharded_state(plan, TTINY, 3, lr=LR)
        state, loss = tr.make_sharded_train_step(plan, TTINY, lr=LR)(state, tokens)
    assert loss.item() == ref_loss.item()
    for got, want in ((state.params, ref.params), (state.opt_state.mu, ref.opt_state.mu),
                      (state.opt_state.nu, ref.opt_state.nu)):
        for a, b in zip(tr._leaves(got), tr._leaves(want)):
            assert torch.equal(a, b)
    assert int(state.step) == int(ref.step) == 1
    assert int(state.opt_state.count) == 1


def test_world_of_one_accumulation_equals_full_batch():
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (4, 16)))
    with world_of_one():
        plan = sh.build_mesh({}, device="cpu")
        full = tr.make_sharded_state(plan, TTINY, 0, lr=LR)
        acc = tr.make_sharded_state(plan, TTINY, 0, lr=LR)
        full, l1 = tr.make_sharded_train_step(plan, TTINY, lr=LR)(full, tokens)
        acc, l2 = tr.make_sharded_train_step(plan, TTINY, lr=LR, accum_steps=2)(acc, tokens)
    assert l2.item() == pytest.approx(l1.item(), rel=1e-6)
    for a, b in zip(tr._leaves(acc.params), tr._leaves(full.params)):
        torch.testing.assert_close(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_unported_axes_and_options_raise():
    """Every axis and option is ported now (tests/test_torch_moe.py,
    test_torch_ring.py, test_torch_ulysses.py, test_torch_pipeline.py): the
    step takes pp, sp and ep and n_micro, and param_specs the MoE layout;
    what still raises is a shape the pipeline cannot cut."""
    from tputopo_torch import pipeline
    from tputopo_torch.moe import MoEConfig

    for axis in ("pp", "sp", "ep"):
        assert callable(tr.make_sharded_train_step(sh.MeshPlan(mesh=None, axes={axis: 2}),
                                                   TTINY, n_micro=2))
    specs = sh.param_specs(sh.MeshPlan(mesh=None, axes={"ep": 2}),
                           dataclasses.replace(TTINY, moe=MoEConfig()))
    assert specs["layers"]["moe"]["w_up"] == (None, "ep", None, None)
    with pytest.raises(ValueError, match="stages"):
        pipeline.pipelined_trunk(tm.init_params(TTINY, device="cpu"),
                                 torch.zeros((4, 16), dtype=torch.long), TTINY,
                                 sh.MeshPlan(mesh=None, axes={"pp": 4}), n_micro=2)
