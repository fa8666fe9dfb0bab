"""Flash attention, forward — the counterpart of
``tputopo/workloads/attention.py``.

On a CUDA tensor, :func:`flash_forward_lse` launches the hand-written
Hopper kernel in ``csrc/flash_fwd.cu``, which replaces the Pallas TPU
kernel ``_flash_fwd_kernel``.  On a CPU tensor it runs
:func:`_flash_forward_lse_plain`, a straightforward PyTorch computation of
the same function that the tests hold against the JAX package and that
``chip_smoke.py`` holds the kernel against on the card.  Nothing falls
back: a CUDA call that cannot launch the kernel raises.

This slice is forward only.  The dQ and dK/dV kernels, and the
``torch.autograd.Function`` around all three, come with the training
slice; until then a call on tensors that require grad raises.

Layout at the public boundary is the JAX one, q/k/v ``[B, S, N, H]`` with
equal head counts (callers expand GQA groups first).  The LSE is an f32
``[B*N, S]`` tensor, rows ordered ``b * N + n``: the reference's
``[BN, n_q, bq]`` is its TPU tiling of the same numbers.
"""

from __future__ import annotations

import ctypes

import torch

from tputopo_torch import _kernels

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k, v, causal, block_q, block_kv):
    B, S, N, H = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    block_q = min(block_q, S)
    block_kv = min(block_kv, S)
    if S % block_q or S % block_kv:
        raise ValueError(f"seq len {S} not divisible by blocks "
                         f"({block_q}, {block_kv})")
    if causal and block_q != block_kv:
        raise ValueError("causal path requires block_q == block_kv")
    return block_q, block_kv


def _flash_forward_lse_plain(q, k, v, *, causal):
    """O and LSE computed whole: scores in f32 with -1e30 masking, P cast
    to V's dtype before P·V (f32 accumulation), LSE = m + log l."""
    B, S, N, H = q.shape
    scale = 1.0 / (H ** 0.5)
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnqk,bknh->bnqh", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l)).reshape(B * N, S)
    return out, lse


def _flash_forward_lse_cuda(q, k, v, *, causal):
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    B, S, N, H = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [B, S, N, H]")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd kernel takes bfloat16 or float32, "
                         f"got {q.dtype}")
    if H % 8 or not 8 <= H <= 128:
        raise ValueError(f"flash_fwd kernel needs head dim a multiple of 8 "
                         f"in [8, 128], got {H}")
    o = torch.empty_like(q)
    lse = torch.empty((B * N, S), dtype=torch.float32, device=q.device)
    kernel = _kernels.FLASH_FWD
    fn = kernel.lib().tputopo_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), B, S, N, H, int(causal), _DTYPE_CODE[q.dtype],
                 1.0 / (H ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err} "
                           f"(B={B}, S={S}, N={N}, H={H}, {q.dtype})")
    kernel.launches += 1
    return o, lse


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block_q: int = 512,
                      block_kv: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v ``[B, S, N, H]`` -> (O ``[B, S, N, H]`` in q's dtype,
    LSE ``[B*N, S]`` f32).

    ``block_q``/``block_kv`` keep the reference's shape contract (S
    divisible by both; causal needs them equal) so the two APIs accept
    and reject the same calls; the CUDA kernel picks its own tiles."""
    _validate(q, k, v, causal, block_q, block_kv)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention is forward-only in this slice of tputopo_torch: "
            "its backward kernels come with the training slice")
    if q.device.type == "cpu":
        return _flash_forward_lse_plain(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return _flash_forward_lse_cuda(q, k, v, causal=causal)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """q/k/v ``[B, S, N, H]`` -> O ``[B, S, N, H]`` in q's dtype."""
    return flash_forward_lse(q, k, v, causal=causal, block_q=block_q,
                             block_kv=block_kv)[0]


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Einsum reference (the model's path), for kernel verification."""
    B, S, N, H = q.shape
    scale = 1.0 / (H ** 0.5)
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        logits = logits.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.float()).to(q.dtype)
