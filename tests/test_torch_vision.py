"""The port's conv classifier (tputopo_torch.vision) against the JAX
package's, at f32 on the reference's test config (16x16 images, widths
8/16) and at the default 28x28: the same parameters, carried across with
the HWIO -> OIHW kernel turn, and the same synthetic batch.  The forward
check catches both layout traps (XLA's asymmetric SAME padding at stride
2, and the NHWC flatten before fc1); then loss and grads, a short training
trace under optax's ``adam``, and 2 gloo ranks of the data-parallel step
against one process."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import run_ranks
from tputopo.workloads import vision as jv
from tputopo.workloads.sharding import build_mesh
from tputopo_torch import train as tr
from tputopo_torch import vision as tv
from tputopo_torch.convert import vision_params_from_numpy

torch.set_num_threads(1)

SMALL = dict(image_size=16, widths=(8, 16), d_hidden=32)
CFGS = {"small": (jv.VisionConfig(**SMALL, compute_dtype=jnp.float32),
                  tv.VisionConfig(**SMALL, compute_dtype=torch.float32)),
        "default": (jv.VisionConfig(compute_dtype=jnp.float32),
                    tv.VisionConfig(compute_dtype=torch.float32))}
# The whole model's forward tolerance (tests/test_attention.py:61) and the
# reference's grad tolerance (tests/test_attention.py:90).
FWD_TOL, GRAD_TOL = 2e-4, 5e-5
TRACE_TOL = 1e-4


def _params(jcfg, seed=0):
    jp = jv.init_vision_params(jcfg, jax.random.key(seed))
    return jp, vision_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_forward_matches_jax(cfg):
    jcfg, tcfg = CFGS[cfg]
    jp, tp = _params(jcfg)
    images, _ = jv.synthetic_batch(jcfg, 8, 0)
    want = np.asarray(jv.vision_forward(jp, images, jcfg))
    got = tv.vision_forward(tp, torch.from_numpy(np.array(images)), tcfg)
    assert got.shape == (8, tcfg.n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_layout_traps_would_show():
    """Symmetric padding, or a flatten in NCHW order, computes another
    function: each moves the logits far outside the forward tolerance."""
    jcfg, tcfg = CFGS["default"]
    jp, tp = _params(jcfg)
    images, _ = jv.synthetic_batch(jcfg, 4, 1)
    want = np.asarray(jv.vision_forward(jp, images, jcfg))
    x = torch.from_numpy(np.array(images)).permute(0, 3, 1, 2)
    sym = x
    for i in range(len(tcfg.widths)):
        sym = torch.relu(torch.nn.functional.conv2d(sym, tp[f"conv{i}"], stride=2,
                                                    padding=1))
    nchw = torch.relu(sym.reshape(4, -1) @ tp["fc1"]) @ tp["fc2"]
    assert np.abs(nchw.numpy() - want).max() > 100 * FWD_TOL
    assert tv._same_pad(28) == (0, 1) and tv._same_pad(14) == (0, 1)
    assert tv._same_pad(7) == (1, 1)


@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_synthetic_batch_is_the_reference_arrays(cfg):
    jcfg, tcfg = CFGS[cfg]
    for batch, seed in ((8, 0), (33, 5)):
        jim, jlab = jv.synthetic_batch(jcfg, batch, seed)
        tim, tlab = tv.synthetic_batch(tcfg, batch, seed, device="cpu")
        np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        assert tim.dtype == torch.float32 and tlab.dtype == torch.int64


def test_loss_and_grads_match_jax():
    jcfg, tcfg = CFGS["small"]
    jp, tp = _params(jcfg)
    images, labels = jv.synthetic_batch(jcfg, 16, 1)
    jloss, jgrads = jax.value_and_grad(jv.vision_loss)(jp, images, labels, jcfg)
    leaves = [p.detach().requires_grad_() for p in tr._leaves(tp)]
    tloss = tv.vision_loss(tr._rebuild(tp, leaves), torch.from_numpy(np.array(images)),
                           torch.from_numpy(np.array(labels)), tcfg)
    grads = dict(zip(sorted(tp), torch.autograd.grad(tloss, leaves)))
    assert tloss.item() == pytest.approx(float(jloss), rel=GRAD_TOL)
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        if name.startswith("conv"):
            want = want.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_five_step_trace_matches_jax():
    """Five steps of the port's step (optax ``adam`` semantics) against the
    reference's jitted DP step on a one-device mesh, from the same params
    and batch: the loss trace and the final params."""
    jcfg, tcfg = CFGS["small"]
    jp, tp = _params(jcfg)
    images, labels = jv.synthetic_batch(jcfg, 16, 2)
    plan = build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, opt = jv.make_vision_train_step(plan, jcfg, lr=3e-3)
    jstate = opt.init(jp)
    tstep, topt = tv.make_vision_train_step(None, tcfg, lr=3e-3)
    tstate = topt.init(tp)
    tim, tlab = torch.from_numpy(np.array(images)), torch.from_numpy(np.array(labels))
    jparams = jax.tree.map(jnp.copy, jp)  # the reference's step donates them
    jl, tl = [], []
    for _ in range(5):
        jparams, jstate, loss = jstep(jparams, jstate, images, labels)
        jl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, tim, tlab)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=TRACE_TOL, atol=TRACE_TOL)
    assert tl[-1] < tl[0]
    for name in tp:
        want = np.asarray(jparams[name])
        if name.startswith("conv"):
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(tp[name].numpy(), want, rtol=TRACE_TOL, atol=TRACE_TOL)


def test_adam_is_optax_adam_and_leaves_adamw_alone():
    """The vision optimizer is optax.adam (b2 0.999, no weight decay) on
    the same state as the LM's AdamW, whose constants stay optax.adamw's
    (b2 0.95, weight decay 0.1)."""
    import optax

    rng = np.random.default_rng(3)
    w, g = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    opt = optax.adam(1e-2)
    state = opt.init(jnp.asarray(w))
    upd, _ = opt.update(jnp.asarray(g), state, jnp.asarray(w))
    want = np.asarray(optax.apply_updates(jnp.asarray(w), upd))
    params = {"w": torch.from_numpy(w.copy())}
    adam = tr.Adam(lr=1e-2)
    adam.update_([torch.from_numpy(g)], adam.init(params), params)
    np.testing.assert_allclose(params["w"].numpy(), want, rtol=1e-6, atol=1e-7)
    assert (tr.Adam.B2, tr.Adam().weight_decay) == (0.999, 0.0)
    assert (tr.AdamW.B2, tr.AdamW().weight_decay) == (0.95, 0.1)


def test_training_converges_exp6_style():
    """The reference's Exp.6 proof shape on one process."""
    _, tcfg = CFGS["small"]
    losses = tv.train_vision(None, tcfg, steps=30, batch=32, lr=3e-3, device="cpu")
    assert losses[-1] < 0.25 * losses[0], losses[::10]


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """train_vision over {dp: 2}: each rank the mean over its half of the
    batch, grads summed over dp and halved — the one-process run's trace."""
    _, tcfg = CFGS["small"]
    args = {"cfg": {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()},
            "steps": 5, "batch": 16, "lr": 3e-3, "seed": 4}
    ranks = run_ranks("vision_dp", 2, tmp_path, args)
    want = tv.train_vision(None, tcfg, steps=5, batch=16, lr=3e-3,
                           seed=4, device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5, atol=1e-6)
