"""The port's Mixture-of-Experts layer (tputopo_torch.moe) and expert
parallelism against the JAX package's, on the reference's tiny MoE config
(tests/test_moe.py: vocab 128, d_model 32, 2 layers, 4 experts, top 2):
the capacity-dispatch layer and the drop-free mixture, the seating order
and the drops, the aux loss, the whole forward, a train step, decode and
the serving engine, quantization; then the expert-parallel step on gloo
ranks (``{ep:2}``, ``{ep:2, tp:2}``, ``{dp:2, ep:2}``) against JAX's
single-device step, the aux at its global-mean semantics included."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import adam_state, flat, run_ranks, to_torch, train_state_to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import model as jm
from tputopo.workloads import moe as jmoe
from tputopo.workloads import quant as jq
from tputopo.workloads import serving as js
from tputopo.workloads import train as jt
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import moe as tmoe
from tputopo_torch import quant as tq
from tputopo_torch import serving as ts
from tputopo_torch import sharding as sh
from tputopo_torch import train as tr

torch.set_num_threads(1)

BASE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
MOE = dict(n_experts=4, top_k=2, capacity_factor=2.0)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32, moe=jmoe.MoEConfig(**MOE))
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32, moe=tmoe.MoEConfig(**MOE))
# The reference's own tolerances: the layer against the drop-free mixture
# (tests/test_moe.py:46), the whole forward (tests/test_attention.py:61),
# a train step's loss and params and the AdamW moments made of grads
# (tests/test_workloads.py, tests/test_attention.py:90), the sharded step
# (tests/test_moe.py:126-135: loss rel 1e-4, params 2e-4).
LAYER_TOL, FWD_TOL, TOL, GRAD_TOL = 2e-5, 2e-4, 2e-5, 5e-5
SHARD_LOSS_REL, SHARD_PARAM_TOL = 1e-4, 2e-4
# The aux is a handful of f32 sums: the same to f32 rounding.
AUX_REL = 1e-6
LR = 1e-2  # the sharded step's, as tests/test_moe.py
# One step at lr 1e-2 moves a leaf whose grad is near 0 by up to lr in either
# direction (Adam's first update is lr * g / (|g| + eps)), so the single-process
# step, held at 2e-5, takes the port's usual step size.
STEP_LR = 3e-4


def _toks(seed=0, shape=(2, 32)):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], shape)


def _pair(cfg_kw=None, moe_kw=None):
    jcfg = dataclasses.replace(JCFG, **(cfg_kw or {}),
                               moe=dataclasses.replace(JCFG.moe, **(moe_kw or {})))
    tcfg = dataclasses.replace(TCFG, **(cfg_kw or {}),
                               moe=dataclasses.replace(TCFG.moe, **(moe_kw or {})))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            {k: v[0] for k, v in tp["layers"]["moe"].items()})


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_init_layout_and_capacity():
    p = tmoe.init_moe_params(TCFG, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (2, 32, 4), "w_gate": (2, 4, 32, 64), "w_up": (2, 4, 32, 64),
        "w_down": (2, 4, 64, 32)}
    assert torch.equal(p["w_up"], tmoe.init_moe_params(TCFG, 0, device="cpu")["w_up"])
    for T in (1, 16, 32, 100, 2048):
        for cf in (0.5, 1.25, 2.0, 4.0):
            m = dict(n_experts=8, top_k=2, capacity_factor=cf)
            assert tmoe.MoEConfig(**m).capacity(T) == jmoe.MoEConfig(**m).capacity(T)
    tp = tm.init_params(TCFG, 0, device="cpu")
    assert set(tp["layers"]) == {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "moe"}


@pytest.mark.parametrize("T", [16, 6])
def test_moe_mlp_and_reference_match_jax(params, T):
    """T=16, k=2, E=4, cf=2: capacity 16 == T, nothing can overflow, so the
    dispatch path also equals the drop-free mixture (tests/test_moe.py)."""
    jl, tl = _layer0(*params)
    x = _x((2, T, 32))
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), jl, JCFG)
    out, aux = tmoe.moe_mlp(torch.from_numpy(x), tl, TCFG)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_REL)
    ref = tmoe.moe_mlp_reference(torch.from_numpy(x), tl, TCFG)
    jref = jmoe.moe_mlp_reference(jnp.asarray(x), jl, JCFG)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=LAYER_TOL, atol=LAYER_TOL)
    assert aux.item() > 0


def test_capacity_drops_are_bounded_and_match_jax():
    """top_k=1, cf=0.5: a kept token equals the drop-free mixture, a dropped
    one is 0, both occur, and the drops are JAX's."""
    jcfg, tcfg = _pair({"n_layers": 1}, {"top_k": 1, "capacity_factor": 0.5})
    jp = jm.init_params(jcfg, jax.random.key(0))
    jl, tl = _layer0(jp, to_torch(jp))
    x = _x((1, 32, 32))
    out = tmoe.moe_mlp(torch.from_numpy(x), tl, tcfg)[0].numpy()[0]
    ref = tmoe.moe_mlp_reference(torch.from_numpy(x), tl, tcfg).numpy()[0]
    kept = np.isclose(out, ref, rtol=LAYER_TOL, atol=LAYER_TOL).all(axis=-1)
    dropped = np.isclose(out, 0.0, atol=1e-6).all(axis=-1)
    assert (kept | dropped).all() and dropped.any() and kept.any()
    jout = np.asarray(jmoe.moe_mlp(jnp.asarray(x), jl, jcfg)[0])[0]
    assert (np.isclose(jout, 0.0, atol=1e-6).all(axis=-1) == dropped).all()


def test_capacity_seating_is_slot_rank_order():
    """With every token routed to expert 2, exactly the first C survive."""
    _, tcfg = _pair({"n_layers": 1}, {"top_k": 1, "capacity_factor": 1.0})
    p = {k: v[0] for k, v in tmoe.init_moe_params(tcfg, 0, device="cpu").items()}
    p["router"] = torch.zeros((32, 4))
    p["router"][:, 2] = 1.0
    x = torch.from_numpy(np.abs(_x((1, 32, 32)))) + 0.1
    out = tmoe.moe_mlp(x, p, tcfg)[0].numpy()[0]
    C = tcfg.moe.capacity(32)
    assert C == 8
    live = ~np.isclose(out, 0.0, atol=1e-6).all(axis=-1)
    assert live[:C].all() and not live[C:].any()


def test_moe_forward_matches_jax(params):
    jp, tp = params
    toks = _toks()
    jlogits, jaux = jm.forward_with_aux(jp, jnp.asarray(toks), JCFG)
    logits, aux = tm.forward_with_aux(tp, torch.from_numpy(toks), TCFG)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=AUX_REL)
    # balanced top-k routing gives weight * n_layers; skew only raises it
    assert aux.item() >= 0.9 * TCFG.moe.aux_loss_weight * TCFG.n_layers


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_step_matches_jax(accum):
    toks = _toks(1, (4, 32))
    jstate = jt.make_train_state(JCFG, jax.random.key(2), lr=STEP_LR)
    tstate = train_state_to_torch(jstate)
    jnew, jloss = jax.jit(lambda s, t: jt.train_step(s, t, JCFG, lr=STEP_LR,
                                                     accum_steps=accum))(
        jax.tree.map(jnp.copy, jstate), jnp.asarray(toks))
    tnew, tloss = tr.train_step(tstate, torch.from_numpy(toks), TCFG, lr=STEP_LR,
                                accum_steps=accum)
    assert tloss.item() == pytest.approx(float(jloss), rel=TOL)
    adam = adam_state(jnew)
    for name, want, got in (("params", jnew.params, tnew.params),
                            ("mu", adam.mu, tnew.opt_state.mu),
                            ("nu", adam.nu, tnew.opt_state.nu)):
        tol = TOL if name == "params" else GRAD_TOL
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want), tr._leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol, atol=tol,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_moe_decode_matches_jax(params):
    jp, tp = params
    prompt = _toks(3, (2, 8))
    ref = np.asarray(jd.generate(jp, jnp.asarray(prompt), JCFG, max_new=6))
    out = td.generate(tp, torch.from_numpy(prompt), TCFG, max_new=6)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("weights", ["raw", "int8"])
def test_moe_serving_engine_matches_jax(params, weights):
    jp, tp = params
    if weights == "int8":
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 128, (n,)).tolist(), m) for n, m in ((5, 4), (12, 6), (3, 5))]
    rows = []
    for eng in (js.ServingEngine(jp, JCFG, slots=2, max_len=32, prompt_pad=16),
                ts.ServingEngine(tp, TCFG, slots=2, max_len=32, prompt_pad=16)):
        ids = [eng.submit(p, max_new=m) for p, m in reqs]
        res = eng.run()
        rows.append([list(res[i]) for i in ids])
    assert rows[0] == rows[1]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_moe_leaves_bit_for_bit(params, bits):
    jp, tp = params
    kw = {"bits": bits, "group_size": 16} if bits == 4 else {}
    jq_tree = to_torch(jax.tree.map(np.asarray, jq.quantize_params(jp, **kw)))
    tq_tree = tq.quantize_params(tp, **kw)
    assert torch.equal(tq_tree["layers"]["moe"]["router"], tp["layers"]["moe"]["router"])
    for name in ("w_gate", "w_up", "w_down"):
        want, got = jq_tree["layers"]["moe"][name], tq_tree["layers"]["moe"][name]
        assert set(want) == set(got)
        for k in want:
            assert torch.equal(want[k], got[k]), (name, k)


def test_moe_param_specs_split_experts_over_ep_and_ffn_over_tp():
    plan = sh.MeshPlan(mesh=None, axes={"pp": 2, "dp": 1, "sp": 1, "ep": 2, "tp": 2})
    moe = sh.param_specs(plan, TCFG)["layers"]["moe"]
    assert moe == {"router": ("pp", None, None), "w_gate": ("pp", "ep", None, "tp"),
                   "w_up": ("pp", "ep", None, "tp"), "w_down": ("pp", "ep", "tp", None)}
    assert "w_gate" not in sh.param_specs(plan, TCFG)["layers"]


# ---- expert parallelism on gloo ranks --------------------------------------

CASES = {  # name: (world, axes)
    "ep2": (2, {"ep": 2}),
    "ep2tp2": (4, {"ep": 2, "tp": 2}),
    "dp2ep2": (4, {"dp": 2, "ep": 2}),
}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """JAX's single-device forward, loss and step, and one run of the
    port's sharded step per world size."""
    toks = _toks(5, (4, 32))
    state = jt.make_train_state(JCFG, jax.random.key(2), lr=LR)
    p0 = flat(jax.device_get(state.params))
    logits, aux = jm.forward_with_aux(state.params, jnp.asarray(toks), JCFG)
    loss = float(jt.loss_fn(state.params, jnp.asarray(toks), JCFG))
    new, _ = jax.jit(lambda s, t: jt.train_step(s, t, JCFG, lr=LR))(state, jnp.asarray(toks))
    cfg = {**BASE, "moe": MOE}
    runs = {}
    for world in sorted({w for w, _ in CASES.values()}):
        d = tmp_path_factory.mktemp(f"moe{world}")
        np.savez(d / "inputs.npz", tokens=toks, **{f"p.{k}": v for k, v in p0.items()})
        cases = [dict(name=n, axes=a, logits=True) for n, (w, a) in CASES.items()
                 if w == world]
        ranks = run_ranks("parallel_step", world, d, {"cfg": cfg, "cases": cases, "lr": LR})
        runs[world] = (ranks, dict(np.load(d / "rank0.npz")))
    return {"logits": np.asarray(logits), "aux": float(aux), "loss": loss,
            "params": flat(jax.device_get(new.params)), "runs": runs}


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_parallel_step_matches_jax_single_device(sharded, case):
    world, axes = CASES[case]
    ranks, arrays = sharded["runs"][world]
    np.testing.assert_allclose(arrays[f"{case}.logits"], sharded["logits"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    for r in ranks:
        assert r[case]["aux"] == pytest.approx(sharded["aux"], rel=AUX_REL * 10)
        assert r[case]["loss"] == pytest.approx(sharded["loss"], rel=SHARD_LOSS_REL)
        assert r[case]["step"] == 1 and r[case]["host_staged"]["calls"] == 0
        E, F = MOE["n_experts"], BASE["d_ff"]
        assert r[case]["local"]["layers.moe.w_gate"] == [
            2, E // axes["ep"], 32, F // axes.get("tp", 1)]
    for name, ref in sharded["params"].items():
        np.testing.assert_allclose(arrays[f"{case}.{name}"], ref, rtol=SHARD_PARAM_TOL,
                                   atol=SHARD_PARAM_TOL, err_msg=name)
