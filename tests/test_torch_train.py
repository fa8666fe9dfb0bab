"""The port's training step (tputopo_torch.train) against the JAX package's
``train_step`` on the same state, converted leaf for leaf with its optax
AdamW moments, on the tiny f32 config of ``tests/test_workloads.py``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import adam_state, train_state_to_torch
from tputopo.workloads import model as jm
from tputopo.workloads import train as jt
from tputopo_torch import attention as att
from tputopo_torch import model as tm
from tputopo_torch import train as tr

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32)
# The reference's own train-step tolerance (tests/test_workloads.py): one
# AdamW step moves a weight by ~lr; 2e-5 of that is f32 summation noise.
TOL = 2e-5


def _configs(**kw):
    return (jm.ModelConfig(**BASE, compute_dtype=jnp.float32, **kw),
            tm.ModelConfig(**BASE, compute_dtype=torch.float32, **kw))


def _tokens(batch=4, seq=16, seed=0):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (batch, seq))


def _close(tree, jax_tree, tol=TOL):
    for got, ref in zip(tr._leaves(tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_train_step_matches_jax(attn_impl):
    """Loss, updated params and AdamW moments of one step, from the same
    state; "flash" runs the Pallas kernels in interpret mode on the JAX
    side and the kernels' plain versions on the port's."""
    jcfg, tcfg = _configs(attn_impl=attn_impl)
    tokens = _tokens()
    js0 = jt.make_train_state(jcfg, jax.random.key(0))
    ts0 = train_state_to_torch(js0)
    js1, jloss = jax.jit(lambda s, t: jt.train_step(s, t, jcfg))(js0, jnp.asarray(tokens))
    ts1, tloss = tr.train_step(ts0, torch.from_numpy(tokens), tcfg)
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    _close(ts1.params, js1.params)
    adam = adam_state(js1)
    _close(ts1.opt_state.mu, adam.mu)
    _close(ts1.opt_state.nu, adam.nu)
    assert int(ts1.opt_state.count) == int(adam.count) == 1
    assert int(ts1.step) == int(js1.step) == 1


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 gives the full-batch gradient for the dense model, so
    one step from the same state lands on the same loss and params."""
    _, tcfg = _configs()
    tokens = torch.from_numpy(_tokens())
    s1, l1 = tr.train_step(tr.make_train_state(tcfg, 0, device="cpu"), tokens, tcfg)
    s2, l2 = tr.train_step(tr.make_train_state(tcfg, 0, device="cpu"), tokens, tcfg,
                           accum_steps=2)
    assert l2.item() == pytest.approx(l1.item(), rel=1e-5)
    for a, b in zip(tr._leaves(s1.params), tr._leaves(s2.params)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="not divisible"):
        tr.train_step(s1, tokens[:3], tcfg, accum_steps=2)


def test_remat_policies_agree_and_recompute_as_named(monkeypatch):
    """remat is a memory policy, not math: block/dots/none give the same
    loss and grads.  Per step the flash forward runs 2·L times under
    "block" (forward + recompute) and L times under "dots" (its (o, lse)
    kept) and "none"."""
    calls = []
    plain = att._flash_forward_lse_plain
    monkeypatch.setattr(att, "_flash_forward_lse_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _, tcfg = _configs(attn_impl="flash")
    params = tm.init_params(tcfg, 0, device="cpu")
    tokens = torch.from_numpy(_tokens(batch=2))
    want = {"block": 2 * tcfg.n_layers, "dots": tcfg.n_layers, "none": tcfg.n_layers}
    results = {}
    for remat, n in want.items():
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=remat)
        results[remat] = tr.loss_and_grads(params, tokens, cfg)
        assert len(calls) == n, (remat, len(calls))
    loss, grads = results["block"]
    for remat in ("dots", "none"):
        assert results[remat][0].item() == pytest.approx(loss.item(), rel=1e-6)
        for a, b in zip(results[remat][1], grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        tr.loss_and_grads(params, tokens, dataclasses.replace(tcfg, remat="bogus"))


def test_train_step_reduces_loss():
    _, tcfg = _configs()
    state = tr.make_train_state(tcfg, 1, lr=1e-2, device="cpu")
    tokens = torch.from_numpy(_tokens())
    state, first = tr.train_step(state, tokens, tcfg, lr=1e-2)
    for _ in range(10):
        state, loss = tr.train_step(state, tokens, tcfg, lr=1e-2)
    assert loss.item() < first.item()
    assert int(state.step) == int(state.opt_state.count) == 11


def test_converted_jax_state_matches_make_train_state():
    """A JAX TrainState converted with its optax moments has the port's
    own TrainState's structure, shapes and dtypes, and zeroed moments."""
    jcfg, tcfg = _configs()
    conv = train_state_to_torch(jt.make_train_state(jcfg, jax.random.key(0)))
    own = tr.make_train_state(tcfg, 0, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)

    for part in (lambda s: s.params, lambda s: s.opt_state.mu,
                 lambda s: s.opt_state.nu):
        assert shapes(part(conv)) == shapes(part(own))
    for s in (conv, own):
        assert s.step.dtype == s.opt_state.count.dtype == torch.int32
        assert int(s.step) == int(s.opt_state.count) == 0
        assert all(not m.any() for m in tr._leaves(s.opt_state.mu))


def test_make_train_state_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.make_train_state(tcfg)
    assert tr.make_train_state(tcfg, device="cpu").params["embed"].device.type == "cpu"
