"""The port's ring attention (tputopo_torch.ring) and the context-parallel
model against the JAX package's, on gloo ranks: the einsum and flash ring
bodies (the flash kernels' plain versions on the CPU), causal and not, on
``{sp:4}`` against JAX's ``ring_attention``, outputs and the grads of q, k
and v; the narrow GQA rotation; the model's forward on ``{dp:2, sp:2}``; a
train step on ``{sp:2}`` and ``{sp:2, tp:2}`` against JAX's single-device
step; a forced ``attn_impl`` under sp; and an MoE model under ``{sp:2}``,
whose capacity and seats must count the whole sequence."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("tputopo.workloads.ring", exc_type=ImportError,
                    reason="tputopo.workloads.ring needs jax >= 0.8 (jax.shard_map)")

import jax.numpy as jnp

from tests.torch_parity import flat, run_ranks
from tputopo.workloads import model as jm
from tputopo.workloads import moe as jmoe
from tputopo.workloads import train as jt
from tputopo.workloads.ring import ring_attention
from tputopo.workloads.sharding import build_mesh
from tputopo_torch import model as tm
from tputopo_torch import ring as tring
from tputopo_torch import sharding as sh

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
# The reference's tolerances (tests/test_ring.py): the ring against
# attention over the whole sequence 3e-5, grads 5e-5, the whole model 2e-4;
# and the sharded step's against the single-device one
# (tests/test_workloads.py:116-137): loss rel 2e-4, params rtol 2e-3 /
# atol 2e-5.
ATT_TOL, GRAD_TOL, FWD_TOL = 3e-5, 5e-5, 2e-4
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5
LR = 1e-2

ATT_CASES = {  # name: (impl, causal, kv_group)
    "einsum_causal": ("einsum", True, 1),
    "einsum_full": ("einsum", False, 1),
    "flash_causal": ("flash", True, 1),
    "flash_full": ("flash", False, 1),
    "einsum_gqa": ("einsum", True, 2),
    "flash_gqa": ("flash", True, 2),
}
# (B, S, N, H): S / sp = 32 per rank, so the flash body runs 32-row blocks
SHAPE = (2, 128, 4, 8)


def _qkv(kv_group, seed=0):
    rng = np.random.default_rng(seed)
    B, S, N, H = SHAPE
    q, do = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, N // kv_group, H)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    """JAX's ring attention (dp 2 x sp 4 over its 8 CPU devices) and the
    port's on 4 gloo ranks {sp: 4}, per case: output and grads."""
    plan = build_mesh({"dp": 2, "sp": 4, "tp": 1})
    d = tmp_path_factory.mktemp("ring_att")
    inputs, ref = {}, {}
    for g in (1, 2):
        q, k, v, do = _qkv(g)
        inputs.update({f"g{g}.q": q, f"g{g}.k": k, f"g{g}.v": v, f"g{g}.do": do})
    for name, (impl, causal, g) in ATT_CASES.items():
        q, k, v, do = (jnp.asarray(inputs[f"g{g}.{n}"]) for n in ("q", "k", "v", "do"))

        def loss(q, k, v, impl=impl, causal=causal, g=g):
            out = ring_attention(q, k, v, plan, causal=causal, kv_group=g, impl=impl)
            return (out * do).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                     has_aux=True))(q, k, v)
        ref[name] = [np.asarray(t) for t in (out, *grads)]
    np.savez(d / "inputs.npz", **inputs)
    cases = [dict(name=n, axes={"sp": 4}, fn="ring", impl=impl, causal=causal,
                  kv_group=g, inputs=f"g{g}.") for n, (impl, causal, g) in ATT_CASES.items()]
    ranks = run_ranks("sp_attention", 4, d, {"cases": cases})
    return ref, ranks, dict(np.load(d / "rank0.npz"))


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_ring_bodies_match_jax_ring_attention(attention_runs, case):
    ref, ranks, arrays = attention_runs
    for r in ranks:
        assert r[case]["local"] == [2, 32, 4, 8]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        tol = ATT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(arrays[f"{case}.{name}"], ref[case][i], rtol=tol,
                                   atol=tol, err_msg=name)


def test_chunk_cases_and_shape_rule():
    assert [tring._chunk_case(1, s, True) for s in range(3)] == [
        tring.FULL, tring.DIAG, tring.SKIP]
    assert tring._chunk_case(0, 1, False) == tring.FULL
    assert tring._flash_shapes_ok(4096) and tring._flash_shapes_ok(32)
    assert not tring._flash_shapes_ok(8) and not tring._flash_shapes_ok(300)


def test_forced_flash_and_einsum_not_rerouted_by_the_sp_plan():
    plan = sh.MeshPlan(mesh=None, axes={"dp": 2, "sp": 2, "tp": 2})
    with sh.activate(plan):
        for impl in ("flash", "einsum"):
            assert tm._ring_plan(dataclasses.replace(TCFG, attn_impl=impl)) is None
        assert tm._ring_plan(TCFG) is plan
    assert tm._ring_plan(TCFG) is None


# ---- the model under sp ----------------------------------------------------

MOE_CFG = {"n_layers": 1, "moe": {"n_experts": 4, "top_k": 2, "capacity_factor": 1.0}}
MODEL_CASES = {  # name: (world, axes, cfg overrides, params tree)
    "dp2sp2": (4, {"dp": 2, "sp": 2}, {}, "p"),
    "sp2tp2": (4, {"sp": 2, "tp": 2}, {}, "p"),
    "sp2": (2, {"sp": 2}, {}, "p"),
    "sp2_forced_einsum": (2, {"sp": 2}, {"attn_impl": "einsum"}, "p"),
    "sp2_moe": (2, {"sp": 2}, MOE_CFG, "m"),
}


def _jax_reference(cfg, seed, toks):
    state = jt.make_train_state(cfg, jax.random.key(seed), lr=LR)
    params = flat(jax.device_get(state.params))
    logits, aux = jax.jit(lambda p, t: jm.forward_with_aux(p, t, cfg))(
        state.params, jnp.asarray(toks))
    loss = float(jax.jit(lambda p, t: jt.loss_fn(p, t, cfg))(state.params, jnp.asarray(toks)))
    new, _ = jax.jit(lambda s, t: jt.train_step(s, t, cfg, lr=LR))(state, jnp.asarray(toks))
    return params, {"logits": np.asarray(logits), "aux": float(aux), "loss": loss,
                    "params": flat(jax.device_get(new.params))}


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    toks = np.random.default_rng(0).integers(0, 64, (4, 32))
    moe = dataclasses.replace(JCFG, n_layers=1,
                              moe=jmoe.MoEConfig(**MOE_CFG["moe"]))
    p, ref = _jax_reference(JCFG, 2, toks)
    m, ref_moe = _jax_reference(moe, 3, toks)
    runs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"ring_model{world}")
        np.savez(d / "inputs.npz", tokens=toks, **{f"p.{k}": v for k, v in p.items()},
                 **{f"m.{k}": v for k, v in m.items()})
        cases = [dict(name=n, axes=a, cfg=c, params=t, logits=True)
                 for n, (w, a, c, t) in MODEL_CASES.items() if w == world]
        ranks = run_ranks("parallel_step", world, d,
                          {"cfg": dict(BASE), "cases": cases, "lr": LR})
        runs[world] = (ranks, dict(np.load(d / "rank0.npz")))
    return {"p": ref, "m": ref_moe}, runs


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_context_parallel_model_matches_jax_single_device(model_runs, case):
    refs, runs = model_runs
    world, _, _, tree = MODEL_CASES[case]
    ref = refs[tree]
    ranks, arrays = runs[world]
    np.testing.assert_allclose(arrays[f"{case}.logits"], ref["logits"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    for r in ranks:
        assert r[case]["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
        assert r[case]["aux"] == pytest.approx(ref["aux"], rel=1e-5)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(arrays[f"{case}.{name}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)


def test_moe_capacity_binds_in_the_sp_case(model_runs):
    """The MoE case must drop tokens, or it would not test the seating:
    the drop-free mixture's logits differ from the capacity path's."""
    refs, _ = model_runs
    toks = np.random.default_rng(0).integers(0, 64, (4, 32))
    moe = dataclasses.replace(JCFG, n_layers=1, moe=jmoe.MoEConfig(**MOE_CFG["moe"]))
    state = jt.make_train_state(moe, jax.random.key(3), lr=LR)
    roomy = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, capacity_factor=2.0))
    logits = np.asarray(jm.forward(state.params, jnp.asarray(toks), roomy))
    assert not np.allclose(logits, refs["m"]["logits"], atol=FWD_TOL)
