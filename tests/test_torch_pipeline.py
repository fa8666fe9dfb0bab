"""The port's GPipe pipeline (tputopo_torch.pipeline) against the JAX
package, on gloo ranks: the pipelined forward and train step on ``{pp:2,
dp:2}`` (M = pp), ``{pp:2, tp:2}`` and ``{pp:4}`` (M = 2 pp), with
gradient accumulation on top, against JAX's single-device forward and step
(the pipeline is layout, not math); the compositions ``pp x sp x tp`` and,
with MoE, ``pp x ep x tp`` on 8 ranks; the shape errors; and the count of
layer calls, which shows that the port computes no bubble tick."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import flat, run_ranks, to_torch, world_of_one
from tputopo.workloads import model as jm
from tputopo.workloads import moe as jmoe
from tputopo.workloads import train as jt
from tputopo_torch import model as tm
from tputopo_torch import pipeline as tpipe
from tputopo_torch import sharding as sh

torch.set_num_threads(1)

# The reference's pipeline config (tests/test_pipeline.py): 4 layers.
BASE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
MOE = {"n_layers": 2, "moe": {"n_experts": 4, "top_k": 2, "capacity_factor": 2.0}}
# The reference's tolerances (tests/test_pipeline.py): logits 2e-4, the
# pipelined step's loss rel 1e-4 and params 5e-4.
FWD_TOL, LOSS_REL, PARAM_TOL = 2e-4, 1e-4, 5e-4
LR = 1e-2

CASES = {  # name: (world, axes, n_micro, accum, cfg overrides, params tree)
    "pp2dp2": (4, {"pp": 2, "dp": 2}, None, 1, {}, "p"),
    "pp2dp2_accum2": (4, {"pp": 2, "dp": 2}, None, 2, {}, "p"),
    "pp2tp2_m4": (4, {"pp": 2, "tp": 2}, 4, 1, {}, "p"),
    "pp4_m8": (4, {"pp": 4}, 8, 1, {}, "p"),
    "pp2sp2tp2": (8, {"pp": 2, "sp": 2, "tp": 2}, None, 1, {}, "p"),
    "pp2ep2tp2_moe": (8, {"pp": 2, "ep": 2, "tp": 2}, None, 1, MOE, "m"),
}


def _reference(cfg, seed, toks, accum=1, micro=1):
    """JAX's single-device forward, loss and step.  ``micro`` > 1 takes the
    aux per microbatch of rows and averages it, as a pipelined MoE step
    does (the microbatch is the routing group: tests/test_pipeline.py)."""
    state = jt.make_train_state(cfg, jax.random.key(seed), lr=LR)
    params = flat(jax.device_get(state.params))

    def fwd(p, t, c):
        logits, aux = jm.forward_with_aux(p, t, c)
        if micro > 1:
            aux = jnp.mean(jnp.stack([jm.forward_with_aux(p, mb, c)[1]
                                      for mb in jnp.split(t, micro)]))
        return logits, aux

    t = jnp.asarray(toks)
    logits, aux = jax.jit(lambda p, t: fwd(p, t, cfg))(state.params, t)
    loss = float(jax.jit(lambda p, t: jt.loss_fn(p, t, cfg, fwd))(state.params, t))
    new, _ = jax.jit(lambda s, t: jt.train_step(s, t, cfg, lr=LR, forward_fn=fwd,
                                                accum_steps=accum))(state, t)
    return params, {"logits": np.asarray(logits), "aux": float(aux), "loss": loss,
                    "params": flat(jax.device_get(new.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    toks = np.random.default_rng(1).integers(0, 128, (8, 32))
    moe = dataclasses.replace(JCFG, n_layers=2, moe=jmoe.MoEConfig(**MOE["moe"]))
    p, ref = _reference(JCFG, 2, toks)
    _, ref_accum = _reference(JCFG, 2, toks, accum=2)
    m, ref_moe = _reference(moe, 3, toks, micro=2)
    refs = {"p": ref, "p_accum": ref_accum, "m": ref_moe}
    out = {}
    for world in (4, 8):
        d = tmp_path_factory.mktemp(f"pipeline{world}")
        np.savez(d / "inputs.npz", tokens=toks, **{f"p.{k}": v for k, v in p.items()},
                 **{f"m.{k}": v for k, v in m.items()})
        cases = [dict(name=n, axes=a, n_micro=nm, accum=ac, cfg=c, params=t, logits=True)
                 for n, (w, a, nm, ac, c, t) in CASES.items() if w == world]
        ranks = run_ranks("parallel_step", world, d,
                          {"cfg": dict(BASE), "cases": cases, "lr": LR}, timeout=240)
        out[world] = (ranks, dict(np.load(d / "rank0.npz")))
    return refs, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_forward_and_step_match_jax(runs, case):
    refs, out = runs
    world, axes, n_micro, accum, cfg, tree = CASES[case]
    ref = refs[tree + ("_accum" if accum > 1 else "")]
    ranks, arrays = out[world]
    np.testing.assert_allclose(arrays[f"{case}.logits"], ref["logits"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    for r in ranks:
        assert r[case]["aux"] == pytest.approx(ref["aux"], rel=1e-5)
        assert r[case]["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(arrays[f"{case}.{name}"], want, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_stage_holds_its_layers_and_skips_the_bubble(runs, case):
    """A stage holds L / pp layers and, in one step, calls each of them
    once per real microbatch forward and once more recomputing it for the
    backward: 2 * M * L / pp per accumulation microbatch, no bubble tick."""
    _, out = runs
    world, axes, n_micro, accum, cfg, _ = CASES[case]
    layers = cfg.get("n_layers", BASE["n_layers"])
    per_stage = layers // axes["pp"]
    M = n_micro or axes["pp"]
    for r in out[world][0]:
        assert r[case]["local"]["layers.attn_norm"] == [per_stage, BASE["d_model"]]
        assert r[case]["pipeline_blocks"] == 2 * M * per_stage * accum


def test_moe_aux_is_per_microbatch_as_the_reference(runs):
    """The pipelined MoE loss is the reference's only to near parity with
    the unpipelined one (tests/test_pipeline.py:107-130: rel 2e-2): its
    routing groups are the microbatches."""
    refs, out = runs
    moe = dataclasses.replace(JCFG, n_layers=2, moe=jmoe.MoEConfig(**MOE["moe"]))
    toks = np.random.default_rng(1).integers(0, 128, (8, 32))
    _, whole = _reference(moe, 3, toks)
    for r in out[8][0]:
        assert r["pp2ep2tp2_moe"]["loss"] == pytest.approx(whole["loss"], rel=2e-2)


def test_pipeline_shape_validation():
    plan = sh.MeshPlan(mesh=None, axes={"pp": 2, "dp": 2, "tp": 2})
    params = tm.init_params(TCFG, 0, device="cpu")
    toks = torch.zeros((3, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="microbatch"):
        tpipe.pipelined_trunk(params, toks, TCFG, plan)
    odd = dataclasses.replace(TCFG, n_layers=3)
    with pytest.raises(ValueError, match="stages"):
        tpipe.pipelined_trunk(tm.init_params(odd, 0, device="cpu"),
                              torch.zeros((4, 16), dtype=torch.long), odd, plan)


def test_pipelined_forward_without_pp_is_the_plain_forward():
    params = to_torch(jm.init_params(JCFG, jax.random.key(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 16)))
    with world_of_one():
        plan = sh.build_mesh({}, device="cpu")
        logits, aux = tpipe.pipelined_forward_with_aux(params, toks, TCFG, plan)
    want, want_aux = tm.forward_with_aux(params, toks, TCFG)
    assert torch.equal(logits, want) and aux.item() == want_aux.item() == 0.0
