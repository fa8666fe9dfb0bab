"""The port's flash attention (tputopo_torch.attention), forward and
backward, against the JAX package's Pallas kernels, run in interpret mode
on the CPU.

On the CPU the port computes the kernels' plain versions; the CUDA kernels
themselves are held against those plain versions by the ``cuda``-marked
tests here (skipped without a GPU) and by ``chip_smoke.py`` on the card."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import normal
from tputopo.workloads.attention import _flash_backward, _flash_forward_lse
from tputopo.workloads.attention import flash_attention as jax_flash
from tputopo.workloads.attention import reference_attention as jax_reference
from tputopo_torch import _kernels
from tputopo_torch import attention as att

torch.set_num_threads(1)

# The reference's own flash tolerances at f32 (tests/test_attention.py):
# the forward, and the grads.
TOL = 3e-5
GRAD_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("shape,causal,block_q,block_kv", [
    ((2, 64, 2, 16), True, 16, 16),
    ((2, 64, 2, 16), False, 16, 16),
    ((1, 64, 1, 8), False, 16, 32),   # uneven blocks, as ring attention uses
])
def test_flash_forward_lse_matches_jax_kernel(shape, causal, block_q, block_kv):
    (jq, jk, jv), (tq, tk, tv) = both(normal(shape))
    jo, jlse = _flash_forward_lse(jq, jk, jv, causal=causal, block_q=block_q,
                                  block_kv=block_kv, interpret=True)
    to, tlse = att.flash_forward_lse(tq, tk, tv, causal=causal,
                                     block_q=block_q, block_kv=block_kv)
    B, S, N, _ = shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    # JAX tiles the LSE [B*N, n_q, bq]; the port keeps it [B*N, S].
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse).reshape(B * N, S),
                               atol=TOL, rtol=TOL)
    out = att.flash_attention(tq, tk, tv, causal=causal, block_q=block_q,
                              block_kv=block_kv)
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=block_q,
                    block_kv=block_kv, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = both(normal((2, 32, 2, 8), seed=3))
    np.testing.assert_allclose(
        att.reference_attention(tq, tk, tv, causal=causal).numpy(),
        np.asarray(jax_reference(jq, jk, jv, causal=causal)),
        atol=TOL, rtol=TOL)


def test_flash_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in normal((1, 60, 1, 8)))
    with pytest.raises(ValueError, match="divisible"):
        att.flash_attention(q, k, v, block_q=16, block_kv=16)
    q2, k2, v2 = (torch.from_numpy(a) for a in normal((1, 64, 1, 8)))
    with pytest.raises(ValueError, match="block_q == block_kv"):
        att.flash_attention(q2, k2, v2, causal=True, block_q=16, block_kv=32)
    with pytest.raises(ValueError, match="shapes differ"):
        att.flash_attention(q2, k2[:, :32], v2, block_q=16, block_kv=16)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grad_matches_jax_kernels(causal):
    """dQ, dK and dV through the autograd Function against jax.grad
    through the Pallas backward kernels, with a non-constant cotangent so
    every contraction of the dK/dV kernel is exercised."""
    (jq, jk, jv), (tq, tk, tv) = both(normal((1, 32, 2, 8)))
    w = normal((1, 32, 2, 8), seed=7)[0]

    def jax_loss(a, b, c):
        return (jax_flash(a, b, c, causal=causal, block_q=16, block_kv=16,
                          interpret=True) * w).sum()

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = att.flash_attention(*leaves, causal=causal, block_q=16, block_kv=16)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("shape,causal,block_q,block_kv", [
    ((2, 64, 2, 16), True, 16, 16),
    ((2, 64, 2, 16), False, 16, 16),
    ((1, 64, 1, 8), False, 16, 32),
])
def test_flash_backward_matches_jax_kernels(shape, causal, block_q, block_kv):
    """flash_backward against the reference's _flash_backward on the same
    O, LSE and dO (the JAX forward's)."""
    q, k, v = normal(shape, seed=1)
    do = normal(shape, seed=2, n=1)[0]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = both((q, k, v, do))
    jo, jlse = _flash_forward_lse(jq, jk, jv, causal=causal, block_q=block_q,
                                  block_kv=block_kv, interpret=True)
    ref = _flash_backward(jq, jk, jv, jo, jlse, jdo, causal=causal,
                          block_q=block_q, block_kv=block_kv, interpret=True)
    B, S, N, _ = shape
    got = att.flash_backward(tq, tk, tv, torch.from_numpy(np.array(jo)),
                             torch.from_numpy(np.array(jlse).reshape(B * N, S)),
                             tdo, causal=causal, block_q=block_q, block_kv=block_kv)
    for g, r in zip(got, ref):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_backward_takes_plain_versions_and_any_cotangent_layout():
    """CPU tensors launch nothing; an expanded (stride-0) cotangent, the
    grad of ``out.sum()``, gives the same grads as a dense one."""
    q, k, v = (torch.from_numpy(a) for a in normal((1, 32, 2, 8)))
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=16, block_kv=16)
    counts = [kern.launches for kern in _kernels.KERNELS]
    expanded = torch.ones(()).expand(q.shape)
    got = att.flash_backward(q, k, v, o, lse, expanded, block_q=16, block_kv=16)
    dense = att.flash_backward(q, k, v, o, lse, torch.ones_like(q),
                               block_q=16, block_kv=16)
    assert [kern.launches for kern in _kernels.KERNELS] == counts
    for a, b in zip(got, dense):
        assert torch.equal(a, b)
    d = att._flash_d(o, torch.ones_like(q))
    assert torch.equal(got[0], att._flash_dq_plain(q, k, v, torch.ones_like(q),
                                                   lse, d, causal=True))


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in normal((1, 32, 2, 8)))
    before = _kernels.FLASH_FWD.launches
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=16, block_kv=16)
    po, plse = att._flash_forward_lse_plain(q, k, v, causal=True)
    assert _kernels.FLASH_FWD.launches == before
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert lse.dtype == torch.float32 and lse.shape == (2, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,shape,tol", [
    ("float32", True, (2, 64, 2, 16), 3e-5),
    ("float32", False, (1, 200, 2, 128), 3e-5),
    # bf16: P and O are rounded at different points on the two sides.
    ("bfloat16", True, (2, 96, 3, 32), 1.6e-2),
    ("bfloat16", False, (1, 40, 2, 24), 1.6e-2),
    # ragged S inside a 128-row tile; H = 64 (one TMA box); two boxes, all keys
    ("bfloat16", True, (1, 200, 2, 128), 1.6e-2),
    ("bfloat16", True, (2, 192, 2, 64), 1.6e-2),
    ("bfloat16", False, (1, 256, 2, 128), 1.6e-2),
    # five 64-row kv tiles (an odd count for a two-stage ring) and a ragged
    # third 128-row q tile, whose halves see different tile counts if causal
    ("bfloat16", True, (1, 320, 2, 128), 1.6e-2),
    ("bfloat16", False, (1, 320, 2, 128), 1.6e-2),
])
def test_cuda_kernel_matches_plain_version(cuda, dtype, causal, shape, tol):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in normal(shape, seed=5))
    before = _kernels.FLASH_FWD.launches
    o, lse = att.flash_forward_lse(q, k, v, causal=causal, block_q=8, block_kv=8)
    po, plse = att._flash_forward_lse_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(o.float(), po.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,shape,tol", [
    ("float32", True, (2, 64, 2, 16), 5e-5),
    ("float32", False, (1, 200, 2, 128), 5e-5),
    # bf16: norm-relative; P and dS are rounded to bf16 on both sides, so
    # only roundings of nearly equal f32 values may differ (chip_smoke.py).
    ("bfloat16", True, (2, 96, 3, 32), 1e-2),
    ("bfloat16", False, (1, 40, 2, 24), 1e-2),
    ("bfloat16", True, (1, 200, 2, 128), 1e-2),
    ("bfloat16", True, (2, 192, 2, 64), 1e-2),
    ("bfloat16", False, (1, 256, 2, 128), 1e-2),
    ("bfloat16", True, (1, 320, 2, 128), 1e-2),
    ("bfloat16", False, (1, 320, 2, 128), 1e-2),
])
def test_cuda_backward_kernels_match_plain_versions(cuda, dtype, causal, shape, tol):
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(cuda, dt) for a in normal(shape, seed=5, n=4))
    o, lse = att.flash_forward_lse(q, k, v, causal=causal, block_q=8, block_kv=8)
    d = att._flash_d(o, do)
    before = (_kernels.FLASH_DQ.launches, _kernels.FLASH_DKV.launches)
    got = att.flash_backward(q, k, v, o, lse, do, causal=causal, block_q=8, block_kv=8)
    plain = (att._flash_dq_plain(q, k, v, do, lse, d, causal=causal),
             *att._flash_dkv_plain(q, k, v, do, lse, d, causal=causal))
    torch.cuda.synchronize()
    assert (_kernels.FLASH_DQ.launches, _kernels.FLASH_DKV.launches) == (
        before[0] + 1, before[1] + 1)
    for g, p in zip(got, plain):
        if dt == torch.float32:
            torch.testing.assert_close(g, p, atol=tol, rtol=tol)
        else:
            err = (g.float() - p.float()).norm() / p.float().norm()
            assert err.item() <= tol, err.item()
