"""Repairs of two faults of the port's flash path against the reference:
"auto" picked the kernel on CUDA for head dims the kernel rejects, and
the CUDA wrappers refused operands that are views."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tputopo_torch import attention as att
from tputopo_torch import model as tm

torch.set_num_threads(1)

GPU = torch.device("cuda")  # a device object needs no card


@pytest.mark.parametrize("d_model,n_heads,want", [
    (4096, 16, False),  # H = 256: above the kernels' 128
    (48, 4, False),     # H = 12: not a multiple of 8
    (512, 4, True),     # H = 128
    (4096, 32, True),   # H = 128, Llama-3-8B
    (256, 32, True),    # H = 8
    (24, 4, False),     # H = 6
])
def test_auto_picks_the_kernel_only_for_head_dims_it_takes(d_model, n_heads, want):
    cfg = tm.ModelConfig(d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads)
    assert tm._use_flash(cfg, 2048, GPU) is want
    assert tm._use_flash(cfg, 2048, torch.device("cpu")) is False


def test_forced_flash_keeps_raising_in_the_kernel():
    cfg = tm.ModelConfig(d_model=48, n_heads=4, n_kv_heads=4, attn_impl="flash")
    assert tm._use_flash(cfg, 128, GPU) is True  # "flash" is the caller's choice
    args = {"q": torch.zeros(1, 16, 4, 12)}
    with pytest.raises(ValueError, match="head dim a multiple of 8"):
        att._launch_args(att._kernels.FLASH_FWD, args, {}, True, {})


def _views(shape, seed=0, dtype=torch.float32):
    """q, k, v, do as a transposed view, a head slice, a view starting one
    element into its storage, and an expanded tensor."""
    B, S, N, H = shape
    rng = np.random.default_rng(seed)
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((B, N, S, H), (B, S, N + 1, H), (B * S * N * H + 1,), (H,))]
    q = base[0].transpose(1, 2)
    k = base[1][:, :, 1:]
    v = base[2][1:].view(B, S, N, H)
    do = base[3].expand(B, S, N, H)
    return q, k, v, do


def _dense_and_aligned(*ts):
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def test_wrappers_hand_the_kernels_dense_operands(monkeypatch):
    """Whatever the caller's strides, what reaches the kernel side is
    contiguous and 16-byte aligned, as ``_launch_args`` demands; the
    results equal those of the same values laid out densely."""
    seen = []
    fwd, dq, dkv = att._flash_forward_lse_plain, att._flash_dq_plain, att._flash_dkv_plain

    def spy(fn):
        def wrapped(*args, **kw):
            seen.append(_dense_and_aligned(*(a for a in args if torch.is_tensor(a))))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(att, "_flash_forward_lse_plain", spy(fwd))
    monkeypatch.setattr(att, "_flash_dq_plain", spy(dq))
    monkeypatch.setattr(att, "_flash_dkv_plain", spy(dkv))
    q, k, v, do = _views((2, 32, 2, 16))
    assert not any(_dense_and_aligned(t) for t in (q, k, v, do))
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=16, block_kv=16)
    grads = att.flash_backward(q, k, v, o.transpose(1, 2).contiguous().transpose(1, 2),
                               lse, do, causal=True, block_q=16, block_kv=16)
    qv, kv, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = att.flash_attention(qv, kv, vv, causal=True, block_q=16, block_kv=16)
    out.backward(do)
    assert seen and all(seen)
    dense = [t.contiguous() for t in (q, k, v, do)]
    o2, lse2 = fwd(*dense[:3], causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(out, o2)
    d = att._flash_d(o2, dense[3])
    assert torch.equal(grads[0], dq(*dense[:3], dense[3], lse2, d, causal=True))
    assert torch.equal(qv.grad, grads[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_take_views_on_the_card(cuda):
    """The kernels against their plain versions on views: a transposed q,
    a head-sliced k, a v one element into its storage, an expanded dO."""
    q, k, v, do = (t.to(cuda) for t in _views((1, 256, 2, 64), dtype=torch.bfloat16))
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=128, block_kv=128)
    po, plse = att._flash_forward_lse_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), po.float(), atol=1.6e-2, rtol=1.6e-2)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=0)
    got = att.flash_backward(q, k, v, o, lse, do, causal=True, block_q=128, block_kv=128)
    d = att._flash_d(o, do.contiguous())
    want = (att._flash_dq_plain(q, k, v, do, lse, d, causal=True),
            *att._flash_dkv_plain(q, k, v, do, lse, d, causal=True))
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).norm() / w.float().norm()).item() <= 1e-2


@pytest.mark.cuda
def test_auto_forward_with_head_dim_256_runs_on_the_card(cuda):
    cfg = tm.ModelConfig(vocab_size=256, d_model=512, n_layers=1, n_heads=2, n_kv_heads=2,
                         d_ff=256)
    params = tm.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, 256, (1, 128), device=cuda)
    got = tm.forward(params, tokens, cfg)
    want = tm.forward(params, tokens, dataclasses.replace(cfg, attn_impl="einsum"))
    assert torch.equal(got, want)
