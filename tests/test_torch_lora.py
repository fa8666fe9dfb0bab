"""The port's LoRA adapters (tputopo_torch.lora, and quant.qdot's LoRA arm)
against the JAX package's, on the reference's tiny f32 config (vocab 64,
d_model 32, 2 layers, 4 q / 2 kv heads).  The adapter cannot be drawn the
same on both sides (``jax.random`` against a ``torch.Generator``), so it
is carried across from numpy with a nonzero ``b`` where the delta must
show.  The contract: a zero-``b`` adapter is invisible, the wrapped
forward and ``merge_lora`` are the reference's, a quantized base takes the
adapter on top (QLoRA) and refuses to merge, the adapter's train step is
the reference's on one process and on 4 gloo ranks (``{dp:2, tp:2}`` and
``{dp:1, tp:4}``, where tp does not divide the 2 kv heads), and the frozen
base is never written or differentiated.  Adapter checkpoints save,
restore and resume."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import adam_state, run_ranks, to_torch, train_state_to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import lora as jl
from tputopo.workloads import model as jm
from tputopo.workloads import quant as jq
from tputopo.workloads import train as jt
from tputopo.workloads.sharding import build_mesh
from tputopo_torch import checkpoint as ck
from tputopo_torch import decode as td
from tputopo_torch import lora as tl
from tputopo_torch import model as tm
from tputopo_torch import quant as tq
from tputopo_torch import train as tr
from tputopo_torch.convert import lora_from_numpy

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
# The whole model's forward tolerance (tests/test_attention.py:61).
FWD_TOL = 2e-4
# The reference's train-step tolerance for the loss and the updated
# adapter (tests/test_workloads.py), and its grad tolerance for the AdamW
# moments, which are made of grads (tests/test_attention.py:90).
TOL, GRAD_TOL = 2e-5, 5e-5
LR = 3e-4


def _toks(seed=0, shape=(4, 16)):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], shape)


def _adapter(rank=4, targets=jl.DEFAULT_TARGETS, b_scale=0.02):
    """A JAX adapter with a seeded nonzero ``b`` (as tests/test_lora.py
    gives one), and the port's copy of it."""
    lora = jl.init_lora(JCFG, jax.random.key(1), rank=rank, targets=targets)
    for i, t in enumerate(targets):
        lora["layers"][t]["b"] = jax.random.normal(
            jax.random.key(2 + i), lora["layers"][t]["b"].shape) * b_scale
    return lora, lora_from_numpy(jax.tree.map(np.asarray, lora), device="cpu")


@pytest.fixture(scope="module")
def base():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


def test_invalid_targets_are_loud(base):
    for t in ("wo", "w_down"):  # row-parallel
        with pytest.raises(ValueError, match="column-parallel"):
            tl.init_lora(TCFG, targets=(t,), device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tl.init_lora(TCFG, rank=0, device="cpu")
    moe_cfg = dataclasses.replace(TCFG, moe=object())
    for t in ("w_gate", "w_up"):
        with pytest.raises(ValueError, match="MoE expert table"):
            tl.init_lora(moe_cfg, targets=(t,), device="cpu")
    lora = tl.init_lora(TCFG, targets=("wq",), device="cpu")
    lora["layers"]["nope"] = lora["layers"].pop("wq")
    with pytest.raises(ValueError, match="not in base"):
        tl.lora_view(base[1], lora)


def test_init_lora_layout_and_zero_delta():
    lora = tl.init_lora(TCFG, 5, rank=4, alpha=8.0, targets=("wq", "wk", "w_up"),
                        device="cpu")
    ref = jl.init_lora(JCFG, jax.random.key(0), rank=4, alpha=8.0,
                       targets=("wq", "wk", "w_up"))
    for t in ("wq", "wk", "w_up"):
        for k in ("a", "b", "scale"):
            assert lora["layers"][t][k].shape == ref["layers"][t][k].shape
            assert lora["layers"][t][k].dtype == torch.float32
        assert not lora["layers"][t]["b"].any()
        assert torch.equal(lora["layers"][t]["scale"], torch.full((2,), 2.0))
        a = lora["layers"][t]["a"]  # N(0, 1/d)
        assert abs(a.std().item() * np.sqrt(BASE["d_model"]) - 1.0) < 0.2


def test_zero_init_adapter_is_invisible(base):
    tokens = torch.from_numpy(_toks())
    want = tm.forward(base[1], tokens, TCFG)
    for lora in (tl.init_lora(TCFG, 1, rank=4, device="cpu"),
                 _adapter(b_scale=0.0)[1]):
        got = tm.forward(tl.lora_view(base[1], lora), tokens, TCFG)
        assert torch.equal(got, want)


@pytest.mark.parametrize("targets", [("wq", "wv"), ("wk", "w_gate", "w_up")])
def test_lora_view_forward_matches_jax(base, targets):
    jlora, tlora = _adapter(targets=targets)
    tokens = _toks(2)
    want = np.asarray(jm.forward(jl.lora_view(base[0], jlora), jnp.asarray(tokens), JCFG))
    got = tm.forward(tl.lora_view(base[1], tlora), torch.from_numpy(tokens), TCFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    # the delta shows: the wrapped forward is not the base's
    plain = tm.forward(base[1], torch.from_numpy(tokens), TCFG)
    assert (got - plain).abs().max() > 1e-3


def test_merge_lora_equals_the_view_and_the_reference(base):
    jlora, tlora = _adapter()
    tokens = torch.from_numpy(_toks(2))
    merged = tl.merge_lora(base[1], tlora)
    view = tm.forward(tl.lora_view(base[1], tlora), tokens, TCFG)
    # the reference's tolerance for view against merge (tests/test_lora.py)
    torch.testing.assert_close(tm.forward(merged, tokens, TCFG), view,
                               rtol=3e-5, atol=3e-5)
    ref = jl.merge_lora(base[0], jlora)
    for t in ("wq", "wv"):
        np.testing.assert_allclose(merged["layers"][t].numpy(),
                                   np.asarray(ref["layers"][t]), rtol=1e-6, atol=1e-7)
    assert merged["layers"]["wk"] is base[1]["layers"]["wk"]
    assert not torch.equal(merged["layers"]["wq"], base[1]["layers"]["wq"])


@pytest.mark.parametrize("kw", [{"bits": 8}, {"bits": 4, "group_size": 8}])
def test_quantized_base_serves_and_refuses_merge(base, kw):
    jlora, tlora = _adapter()
    tokens = _toks(3)
    jq_base, tq_base = jq.quantize_params(base[0], **kw), tq.quantize_params(base[1], **kw)
    want = np.asarray(jm.forward(jl.lora_view(jq_base, jlora), jnp.asarray(tokens), JCFG))
    got = tm.forward(tl.lora_view(tq_base, tlora), torch.from_numpy(tokens), TCFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    with pytest.raises(ValueError, match="quantized"):
        tl.merge_lora(tq_base, tlora)


@pytest.mark.parametrize("base_kind", ["raw", "int8", "int4"])
def test_qdot_lora_arm_matches_jax(base, base_kind):
    """One layer's wrapped leaf, sliced as the layer loop slices it, against
    the reference's qdot on the same x: base dot plus the f32 delta."""
    jlora, tlora = _adapter()
    jw, tw = base[0]["layers"]["wq"], base[1]["layers"]["wq"]
    if base_kind != "raw":
        kw = {"bits": 8} if base_kind == "int8" else {"bits": 4, "group_size": 8}
        jw = jq.quantize_params(base[0], **kw)["layers"]["wq"]
        tw = tq.quantize_params(base[1], **kw)["layers"]["wq"]
    jleaf = jax.tree.map(lambda a: a[1], {"lora_base": jw, **{
        f"lora_{k}": v for k, v in jlora["layers"]["wq"].items()}})
    tleaf = tm._layer({"wq": {"lora_base": tw, **{
        f"lora_{k}": v for k, v in tlora["layers"]["wq"].items()}}}, 1)["wq"]
    x = np.random.default_rng(7).normal(size=(3, 5, BASE["d_model"])).astype(np.float32)
    want = np.asarray(jq.qdot(jnp.asarray(x), jleaf))
    got = tq.qdot(torch.from_numpy(x), tleaf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_layer_slices_nested_lora_leaves(base):
    """model._layer cuts lora_a, lora_b, lora_scale and the int4 base
    inside the wrapper on their layer axis (int4 must be scan-sliced
    before qdot)."""
    _, tlora = _adapter()
    view = tl.lora_view(tq.quantize_params(base[1], bits=4, group_size=8), tlora)
    for i in range(BASE["n_layers"]):
        leaf = tm._layer(view["layers"], i)["wq"]
        ad = tlora["layers"]["wq"]
        assert torch.equal(leaf["lora_a"], ad["a"][i])
        assert torch.equal(leaf["lora_b"], ad["b"][i])
        assert leaf["lora_scale"].dim() == 0 and leaf["lora_scale"] == ad["scale"][i]
        packed = view["layers"]["wq"]["lora_base"]
        assert torch.equal(leaf["lora_base"]["int4"], packed["int4"][i])
        assert leaf["lora_base"]["int4"].dim() == 3
        assert torch.equal(leaf["lora_base"]["scale"], packed["scale"][i])


@pytest.mark.parametrize("bits", [8, 4])
def test_qlora_decode_matches_dequantized_twin(base, bits):
    """KV-cache decode through the wrapped tree: the quantized base plus
    the adapter equals the dequantized base plus the same adapter, and the
    reference's tokens."""
    jlora, tlora = _adapter()
    kw = {"bits": bits} if bits == 8 else {"bits": bits, "group_size": 8}
    qbase = tq.quantize_params(base[1], **kw)

    def dequantize(t):
        if tq.is_quantized(t):
            return tq.deq(t, torch.float32)
        return {k: dequantize(v) for k, v in t.items()} if isinstance(t, dict) else t

    prompt = torch.from_numpy(_toks(4, (2, 8)))
    got = td.generate(tl.lora_view(qbase, tlora), prompt, TCFG, max_new=6)
    twin = td.generate(tl.lora_view(dequantize(qbase), tlora), prompt, TCFG, max_new=6)
    assert torch.equal(got, twin)
    want = jd.generate(jl.lora_view(jq.quantize_params(base[0], **kw), jlora),
                       jnp.asarray(prompt.numpy()), JCFG, max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_state(adapter):
    """A fresh JAX adapter TrainState on a copy of ``adapter`` (the
    reference's step donates its state)."""
    adapter = jax.tree.map(jnp.copy, adapter)
    return jt.TrainState(params=adapter, opt_state=jt.make_optimizer(LR).init(adapter),
                         step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(base, accum):
    """Two adapter steps against the reference's make_sharded_lora_train_step
    on a one-device mesh, from the same adapter: the loss, the adapter and
    both AdamW moments; the base tree untouched and never differentiated."""
    jlora, _ = _adapter()
    tokens = _toks(1)
    plan = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jl.make_sharded_lora_train_step(plan, JCFG, jlora, lr=LR, accum_steps=accum)
    jstate = _jax_state(jlora)
    tstate = train_state_to_torch(jstate)
    tbase = base[1]
    before = [t.clone() for t in tr._leaves(tbase)]
    for _ in range(2):
        jstate, jloss = jstep(jstate, base[0], jnp.asarray(tokens))
        tstate, tloss = tl.lora_train_step(tstate, tbase, torch.from_numpy(tokens), TCFG,
                                           lr=LR, accum_steps=accum)
        assert tloss.item() == pytest.approx(float(jloss), rel=TOL)
    assert int(tstate.step) == 2 and int(tstate.opt_state.count) == 2
    for got, want in zip(tr._leaves(tstate.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    adam = adam_state(jstate)
    for ours, theirs in ((tstate.opt_state.mu, adam.mu), (tstate.opt_state.nu, adam.nu)):
        for got, want in zip(tr._leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
    # the moments exist for the adapter's leaves only
    assert tr._leaf_names(tstate.opt_state.mu) == tr._leaf_names(tstate.params)
    assert all(torch.equal(a, b) for a, b in zip(before, tr._leaves(tbase)))
    assert not any(t.requires_grad for t in tr._leaves(tbase))
    assert tstate.params["layers"]["wq"]["b"].abs().max() > 0


def test_training_reduces_loss_over_an_int8_base(base):
    """QLoRA training: the frozen base quantized, the adapter learns."""
    lora = tl.init_lora(TCFG, 1, rank=4, device="cpu")
    state = tr.TrainState(params=lora, opt_state=tr.make_optimizer(1e-2).init(lora),
                          step=torch.zeros((), dtype=torch.int32))
    qbase = tq.quantize_params(base[1])
    tokens = torch.from_numpy(_toks(5))
    losses = []
    for _ in range(4):
        state, loss = tl.lora_train_step(state, qbase, tokens, TCFG, lr=1e-2)
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


def test_remat_recomputes_a_lora_layer(monkeypatch):
    """The layer loop sees an adapter's leaves inside the weight dicts as
    trainable, so remat="block" recomputes each layer in the backward
    (the card's launch count, 2·L forward kernels a step, rests on it)."""
    calls = []
    cfg = dataclasses.replace(TCFG, remat="block")
    params = tm.init_params(cfg, 0, device="cpu")
    lora = tl.init_lora(cfg, 1, rank=2, device="cpu")
    leaves = [t.requires_grad_() for t in tr._leaves(lora)]
    orig = tm.transformer_block

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tm, "transformer_block", counted)
    loss = tr.loss_fn(tl.lora_view(params, lora), torch.from_numpy(_toks()), cfg)
    torch.autograd.grad(loss, leaves)
    assert len(calls) == 2 * cfg.n_layers


def test_lora_shardings_follow_the_base_layout():
    from tputopo_torch import sharding as sh

    lora = tl.init_lora(TCFG, rank=2, targets=("wq", "wk", "wv", "w_up"), device="cpu")
    for axes, kv_whole in (({"dp": 2, "tp": 2}, False), ({"dp": 1, "tp": 4}, True)):
        plan = sh.MeshPlan(mesh=None, axes=axes)
        specs = tl.lora_shardings(plan, lora, TCFG)["layers"]
        base = sh.param_specs(plan, TCFG)["layers"]
        for t in ("wq", "wk", "wv", "w_up"):
            assert specs[t]["a"] == (None, None, None) and specs[t]["scale"] == (None,)
            assert specs[t]["b"][2] == base[t][2]  # b's output axis is the base's
        assert (specs["wv"]["b"][2] is None) == kv_whole
    # under pp the adapter's layer axis splits over the stages, as the base's
    pp = sh.MeshPlan(mesh=None, axes={"pp": 2, "tp": 2})
    specs = tl.lora_shardings(pp, lora, TCFG)["layers"]
    assert specs["wq"] == {"a": ("pp", None, None), "b": ("pp", None, "tp"),
                           "scale": ("pp",)}
    assert callable(tl.make_sharded_lora_train_step(pp, TCFG, lora, n_micro=2))


SHARD_CASES = {
    "dp2tp2": {"axes": {"dp": 2, "tp": 2}, "accum": 1},
    # tp 4 does not divide the 2 kv heads: wv and its adapter's b whole
    "tp4": {"axes": {"dp": 1, "tp": 4}, "accum": 1},
    "dp2tp2_accum2": {"axes": {"dp": 2, "tp": 2}, "accum": 2},
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
def sharded(base, tmp_path_factory):
    """The reference's single-device adapter steps and one 4-rank run of
    every case, from the same base, adapter and tokens."""
    jlora, _ = _adapter()
    tokens = _toks(6, (4, 16))
    plan = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    ref = {}
    for accum in (1, 2):
        jstep = jl.make_sharded_lora_train_step(plan, JCFG, jlora, lr=LR,
                                                accum_steps=accum)
        jstate, losses = _jax_state(jlora), []
        for _ in range(2):
            jstate, loss = jstep(jstate, base[0], jnp.asarray(tokens))
            losses.append(float(loss))
        adam = adam_state(jstate)
        ref[accum] = {"losses": losses, "params": _flat(jax.device_get(jstate.params)),
                      "mu": _flat(jax.device_get(adam.mu)),
                      "nu": _flat(jax.device_get(adam.nu))}
    d = tmp_path_factory.mktemp("lora_sharded")
    np.savez(d / "inputs.npz", tokens=tokens,
             **{f"p.{k}": v for k, v in _flat(jax.device_get(base[0])).items()},
             **{f"a.{k}": v for k, v in _flat(jax.device_get(jlora)).items()})
    cases = [dict(name=n, **c) for n, c in SHARD_CASES.items()]
    ranks = run_ranks("lora_sharded", 4, d, {"cases": cases, "lr": LR, "steps": 2})
    return {"ref": ref, "ranks": ranks, "arrays": dict(np.load(d / "rank0.npz"))}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_sharded_lora_step_matches_jax_single_device(sharded, case):
    """Two steps on 4 gloo ranks against the reference's single-device
    steps, at the one-process tolerances."""
    ref = sharded["ref"][SHARD_CASES[case]["accum"]]
    for r in sharded["ranks"]:
        assert r[case]["losses"] == pytest.approx(ref["losses"], rel=TOL)
        assert r[case]["step"] == 2
        assert r[case]["base_unchanged"] and not r[case]["base_requires_grad"]
    for part, tol in (("params", TOL), ("mu", GRAD_TOL), ("nu", GRAD_TOL)):
        for name, want in ref[part].items():
            np.testing.assert_allclose(sharded["arrays"][f"{case}.{part}.{name}"], want,
                                       rtol=tol, atol=tol, err_msg=f"{part}.{name}")


def test_sharded_adapter_shards_follow_the_kv_layout(sharded):
    """b splits its output over tp, except wv's where tp does not divide
    the kv heads (the deviation the port's GQA layout forces)."""
    r_out = BASE["n_heads"] * BASE["d_model"] // BASE["n_heads"]
    kv_out = BASE["n_kv_heads"] * BASE["d_model"] // BASE["n_heads"]
    for r in sharded["ranks"]:
        assert r["dp2tp2"]["b_local"] == {"wq": [2, 4, r_out // 2], "wv": [2, 4, kv_out // 2]}
        assert r["tp4"]["b_local"] == {"wq": [2, 4, r_out // 4], "wv": [2, 4, kv_out]}


def test_adapter_checkpoint_saves_restores_and_resumes(base, tmp_path):
    """A single-process adapter TrainState through save/restore, then a
    step on the restored state equals the step on the original."""
    _, tlora = _adapter()
    tokens = torch.from_numpy(_toks(8))
    state = tr.TrainState(params=tlora, opt_state=tr.make_optimizer(LR).init(tlora),
                          step=torch.zeros((), dtype=torch.int32))
    for _ in range(2):
        state, _ = tl.lora_train_step(state, base[1], tokens, TCFG, lr=LR)
    assert ck.save(tmp_path, state) == 2
    fresh = tl.init_lora(TCFG, 9, rank=4, device="cpu")
    target = tr.TrainState(params=fresh, opt_state=tr.make_optimizer(LR).init(fresh),
                           step=torch.zeros((), dtype=torch.int32))
    got = ck.restore(tmp_path, target)
    assert int(got.step) == 2 and int(got.opt_state.count) == 2
    for a, b in zip(tr._leaves(got.params) + tr._leaves(got.opt_state.mu),
                    tr._leaves(state.params) + tr._leaves(state.opt_state.mu)):
        assert torch.equal(a, b)
    state, l1 = tl.lora_train_step(state, base[1], tokens, TCFG, lr=LR)
    got, l2 = tl.lora_train_step(got, base[1], tokens, TCFG, lr=LR)
    assert l1.item() == l2.item()
    for a, b in zip(tr._leaves(got.params), tr._leaves(state.params)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def piped(base, tmp_path_factory):
    """The reference's single-device adapter steps with 2 accumulation
    microbatches, and the port's on 8 gloo ranks {pp:2, dp:2, tp:2}: the
    forward through the GPipe pipeline, accumulation on top."""
    jlora, _ = _adapter()
    tokens = _toks(5, (8, 32))  # dp * pp * accum = 8
    plan = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jl.make_sharded_lora_train_step(plan, JCFG, jlora, lr=LR, accum_steps=2)
    jstate, losses = _jax_state(jlora), []
    for _ in range(3):
        jstate, loss = jstep(jstate, base[0], jnp.asarray(tokens))
        losses.append(float(loss))
    d = tmp_path_factory.mktemp("lora_piped")
    np.savez(d / "inputs.npz", tokens=tokens,
             **{f"p.{k}": v for k, v in _flat(jax.device_get(base[0])).items()},
             **{f"a.{k}": v for k, v in _flat(jax.device_get(jlora)).items()})
    case = {"name": "pp2dp2tp2", "axes": {"pp": 2, "dp": 2, "tp": 2}, "accum": 2}
    ranks = run_ranks("lora_sharded", 8, d, {"cases": [case], "lr": LR, "steps": 3},
                      timeout=240)
    return {"losses": losses, "params": _flat(jax.device_get(jstate.params)),
            "ranks": ranks, "arrays": dict(np.load(d / "rank0.npz"))}


def test_lora_pipeline_and_accum_compose(piped):
    """The port of tests/test_lora.py::test_lora_pipeline_and_accum_compose:
    with pp > 1 the adapter's step runs the pipelined forward, accumulates
    over 2 microbatches, and converges; here also the reference's
    single-device losses and adapter, step for step."""
    for r in piped["ranks"]:
        got = r["pp2dp2tp2"]
        assert all(np.isfinite(got["losses"]))
        assert got["losses"][2] < got["losses"][1] < got["losses"][0]
        assert got["losses"] == pytest.approx(piped["losses"], rel=TOL)
        assert got["step"] == 3 and got["base_unchanged"]
    for name, want in piped["params"].items():
        np.testing.assert_allclose(piped["arrays"][f"pp2dp2tp2.params.{name}"], want,
                                   rtol=TOL, atol=TOL, err_msg=name)
