"""The port's all-to-all (Ulysses) sequence parallelism
(tputopo_torch.ulysses) against the JAX package's, on gloo ranks:
``a2a_attention`` (einsum and flash bodies, causal and not) against JAX's,
outputs and the grads of q, k and v, with a tp axis, with the narrow GQA
K/V, and the indivisible-heads error; then the model with
``sp_impl="a2a"``: its forward on ``{dp:2, sp:2}`` and a train step on
``{sp:2}`` and ``{sp:2, tp:2}`` against JAX's single-device step."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("tputopo.workloads.ulysses", exc_type=ImportError,
                    reason="tputopo.workloads.ulysses needs jax >= 0.8 (jax.shard_map)")

import jax.numpy as jnp

from tests.torch_parity import flat, run_ranks
from tputopo.workloads import model as jm
from tputopo.workloads import train as jt
from tputopo.workloads.sharding import build_mesh
from tputopo.workloads.ulysses import a2a_attention
from tputopo_torch import ulysses as tu

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32, sp_impl="a2a")
# The reference's tolerances (tests/test_ulysses.py, tests/test_ring.py):
# attention 3e-5, grads 5e-5, the whole model 2e-4; the sharded step's
# (tests/test_workloads.py:116-137): loss rel 2e-4, params rtol 2e-3 /
# atol 2e-5.
ATT_TOL, GRAD_TOL, FWD_TOL = 3e-5, 5e-5, 2e-4
LOSS_REL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5
LR = 1e-2

ATT_CASES = {  # name: (axes, (B, S, N, KV, H), impl, causal)
    "sp4_causal": ({"sp": 4}, (2, 32, 4, 4, 8), "einsum", True),
    "sp4_full": ({"sp": 4}, (2, 32, 4, 4, 8), "einsum", False),
    "sp2tp2": ({"sp": 2, "tp": 2}, (2, 16, 8, 8, 8), "einsum", True),
    "sp2tp2_gqa": ({"sp": 2, "tp": 2}, (2, 32, 8, 4, 8), "einsum", True),
    "sp2tp2_flash": ({"sp": 2, "tp": 2}, (2, 32, 4, 4, 8), "flash", True),
    "sp4_flash_full": ({"sp": 4}, (2, 64, 4, 4, 8), "flash", False),
}


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    """JAX's a2a attention over its 8 CPU devices and the port's on 4 gloo
    ranks, per case: output and grads; and the indivisible-heads case."""
    d = tmp_path_factory.mktemp("a2a")
    rng = np.random.default_rng(0)
    inputs, ref, cases = {}, {}, []
    for name, (axes, (B, S, N, KV, H), impl, causal) in ATT_CASES.items():
        q, do = (rng.normal(size=(B, S, N, H)).astype(np.float32) for _ in range(2))
        k, v = (rng.normal(size=(B, S, KV, H)).astype(np.float32) for _ in range(2))
        inputs.update({f"{name}.q": q, f"{name}.k": k, f"{name}.v": v, f"{name}.do": do})
        plan = build_mesh({"dp": 8 // (axes.get("sp", 1) * axes.get("tp", 1)), **axes})

        def loss(q, k, v, plan=plan, g=N // KV, impl=impl, causal=causal, do=do):
            out = a2a_attention(q, k, v, plan, causal=causal, kv_group=g, impl=impl)
            return (out * do).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                     has_aux=True))(q, k, v)
        ref[name] = [np.asarray(t) for t in (out, *grads)]
        cases.append(dict(name=name, axes=axes, fn="a2a", impl=impl, causal=causal,
                          kv_group=N // KV, inputs=f"{name}."))
    # 2 heads cannot split over sp = 4
    inputs.update({f"bad.{n}": rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
                   for n in ("q", "k", "v", "do")})
    cases.append(dict(name="bad", axes={"sp": 4}, fn="a2a", impl="einsum", causal=True,
                      inputs="bad."))
    np.savez(d / "inputs.npz", **inputs)
    ranks = run_ranks("sp_attention", 4, d, {"cases": cases})
    return ref, ranks, dict(np.load(d / "rank0.npz"))


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_a2a_attention_matches_jax(attention_runs, case):
    ref, ranks, arrays = attention_runs
    axes, (B, S, N, KV, H), _, _ = ATT_CASES[case]
    for r in ranks:
        assert r[case]["local"] == [B, S // axes["sp"], N // axes.get("tp", 1), H]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        tol = ATT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(arrays[f"{case}.{name}"], ref[case][i], rtol=tol,
                                   atol=tol, err_msg=name)


def test_a2a_rejects_indivisible_heads(attention_runs):
    _, ranks, _ = attention_runs
    for r in ranks:
        assert "a2a sequence parallelism needs sp=4" in r["bad"]["error"]


def test_flash_block_and_shape_rule_are_the_reference_chain():
    assert [tu._flash_block(s) for s in (8192, 256, 384, 64)] == [512, 256, 128, 64]
    assert tu._flash_shapes_ok(8192) and not tu._flash_shapes_ok(8)
    assert not tu._flash_shapes_ok(200)


# ---- the model with sp_impl="a2a" -----------------------------------------

MODEL_CASES = {  # name: (world, axes)
    "dp2sp2": (4, {"dp": 2, "sp": 2}),
    "sp2tp2": (4, {"sp": 2, "tp": 2}),
    "sp2": (2, {"sp": 2}),
}


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    toks = np.random.default_rng(0).integers(0, 64, (4, 32))
    state = jt.make_train_state(JCFG, jax.random.key(2), lr=LR)
    params = flat(jax.device_get(state.params))
    ring = dataclasses.replace(JCFG, sp_impl="ring")
    logits = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, ring))(
        state.params, jnp.asarray(toks)))
    loss = float(jax.jit(lambda p, t: jt.loss_fn(p, t, ring))(state.params, jnp.asarray(toks)))
    new, _ = jax.jit(lambda s, t: jt.train_step(s, t, ring, lr=LR))(state, jnp.asarray(toks))
    ref = {"logits": logits, "loss": loss, "params": flat(jax.device_get(new.params))}
    runs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"a2a_model{world}")
        np.savez(d / "inputs.npz", tokens=toks, **{f"p.{k}": v for k, v in params.items()})
        cases = [dict(name=n, axes=a, logits=True) for n, (w, a) in MODEL_CASES.items()
                 if w == world]
        ranks = run_ranks("parallel_step", world, d,
                          {"cfg": {**BASE, "sp_impl": "a2a"}, "cases": cases, "lr": LR})
        runs[world] = (ranks, dict(np.load(d / "rank0.npz")))
    return ref, runs


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_a2a_model_matches_jax_single_device(model_runs, case):
    ref, runs = model_runs
    ranks, arrays = runs[MODEL_CASES[case][0]]
    np.testing.assert_allclose(arrays[f"{case}.logits"], ref["logits"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    for r in ranks:
        assert r[case]["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(arrays[f"{case}.{name}"], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
