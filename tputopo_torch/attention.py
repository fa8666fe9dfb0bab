"""Flash attention, forward and backward — the counterpart of
``tputopo/workloads/attention.py``.

On CUDA tensors the three Pallas TPU kernels of the reference become
hand-written Hopper kernels: ``csrc/flash_fwd.cu`` (``_flash_fwd_kernel``),
``csrc/flash_bwd_dq.cu`` (``_flash_dq_kernel``) and ``csrc/flash_bwd_dkv.cu``
(``_flash_dkv_kernel``).  On CPU tensors each is replaced by its plain
version beside it (``_flash_forward_lse_plain``, ``_flash_dq_plain``,
``_flash_dkv_plain``): a straightforward PyTorch computation of the same
function, with the same dtype casts, that the tests hold against the JAX
package and that ``chip_smoke.py`` holds the kernels against on the card.
Nothing falls back: a CUDA call that cannot launch its kernel raises.

:func:`flash_attention` is differentiable through one
``torch.autograd.Function``.  Its forward saves ``(q, k, v, o, lse)`` as the
reference's ``_flash_vjp_fwd`` does; its backward is :func:`flash_backward`,
the FlashAttention-2 scheme of two kernels, one per output's accumulation
order.  The forward launch is the dispatcher op ``tputopo::flash_fwd``, so
that a selective-checkpoint policy can name it and keep its outputs (the
reference's ``flash_out``/``flash_lse`` checkpoint names, used by the
model's ``remat="dots"``).

Layout at the public boundary is the JAX one, q/k/v ``[B, S, N, H]`` with
equal head counts (callers expand GQA groups first), in any strides: the
wrappers hand the kernels a fresh contiguous copy of an operand that is not
contiguous or not on a 16-byte boundary (:func:`_dense`), and pass the rest
as they are.  The LSE is an f32
``[B*N, S]`` tensor, rows ordered ``b * N + n``: the reference's
``[BN, n_q, bq]`` is its TPU tiling of the same numbers.
"""

from __future__ import annotations

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


# ---- plain versions -------------------------------------------------------

def _scores(q, k, *, causal):
    """scale·QKᵀ in f32 ``[B, N, Sq, Sk]`` with -1e30 above the diagonal
    when causal: the one score tile definition, as ``_masked_scores``."""
    S, H = q.shape[1], q.shape[3]
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * (1.0 / H ** 0.5)
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return s


def _flash_forward_lse_plain(q, k, v, *, causal):
    """O and LSE computed whole: scores in f32 with -1e30 masking, P cast
    to V's dtype before P·V (f32 accumulation), LSE = m + log l."""
    B, S, N, H = q.shape
    s = _scores(q, k, causal=causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnqk,bknh->bnqh", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l)).reshape(B * N, S)
    return out, lse


def _p_and_ds(q, k, v, do, lse, d, *, causal):
    """P = exp(scale·QKᵀ − LSE) (masked entries exactly 0) and
    dS = P∘(dO·Vᵀ − D)·scale, both f32 ``[B, N, Sq, Sk]``."""
    B, S, N, H = q.shape
    p = torch.exp(_scores(q, k, causal=causal) - lse.reshape(B, N, S, 1))
    dp = torch.einsum("bqnh,bknh->bnqk", do.float(), v.float())
    ds = p * (dp - d.reshape(B, N, S, 1)) * (1.0 / H ** 0.5)
    return p, ds


def _flash_dq_plain(q, k, v, do, lse, d, *, causal):
    """dQ = dS·K with dS cast to K's dtype, f32 accumulation, q's dtype."""
    _, ds = _p_and_ds(q, k, v, do, lse, d, causal=causal)
    dq = torch.einsum("bnqk,bknh->bqnh", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype).contiguous()


def _flash_dkv_plain(q, k, v, do, lse, d, *, causal):
    """dV = Pᵀ·dO with P cast to dO's dtype; dK = dSᵀ·Q with dS cast to
    q's dtype; f32 accumulation, k's and v's dtypes."""
    p, ds = _p_and_ds(q, k, v, do, lse, d, causal=causal)
    dv = torch.einsum("bnqk,bqnh->bknh", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnqk,bqnh->bknh", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def _flash_d(o, do):
    """D = rowsum(dO∘O) in f32, ``[B*N, S]``: the one other O(S) residual of
    the backward, computed outside the kernels as the reference does."""
    B, S, N, _ = o.shape
    d = (do.float() * o.float()).sum(dim=-1)  # [B, S, N]
    return d.permute(0, 2, 1).reshape(B * N, S).contiguous()


# ---- the kernels' wrappers ------------------------------------------------

def _dense(*tensors: torch.Tensor) -> tuple:
    """Each tensor as the kernels take it: itself when contiguous and on a
    16-byte boundary, else a fresh contiguous copy (a transposed view, a
    head slice, a storage offset)."""
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def _launch_args(kernel: _kernels.Kernel, tensors: dict, rows: dict, causal: bool,
                 outputs: dict) -> tuple:
    """Check the arguments of ``kernel``'s C entry and return them, the
    stream aside.  ``tensors`` are the [B, S, N, H] operands (q first),
    ``rows`` the [B*N, S] f32 ones; the C function takes their pointers in
    that order, then ``outputs``' pointers, B, S, N, H, causal, the dtype's
    code and the softmax scale."""
    q = tensors["q"]
    B, S, N, H = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{kernel.name} kernel takes bfloat16 or float32, "
                         f"got {q.dtype}")
    if H % 8 or not 8 <= H <= 128:
        raise ValueError(f"{kernel.name} kernel needs head dim a multiple of "
                         f"8 in [8, 128], got {H}")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(q.shape)}")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            # the bf16 kernels read their tiles by TMA, which needs this
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, t in rows.items():
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != (B * N, S) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [{B * N}, {S}] "
                             f"tensor on {q.device}")
    ptrs = [t.data_ptr() for t in (*tensors.values(), *rows.values(), *outputs.values())]
    return (*ptrs, B, S, N, H, int(causal), _DTYPE_CODE[q.dtype], 1.0 / (H ** 0.5))


def _launch(kernel: _kernels.Kernel, tensors: dict, rows: dict, causal: bool,
            outputs: dict):
    """Launch ``kernel`` on the current stream and count the launch."""
    args = _launch_args(kernel, tensors, rows, causal, outputs)
    q = tensors["q"]
    with torch.cuda.device(q.device):
        err = kernel.entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        B, S, N, H = q.shape
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError {err} "
                           f"(B={B}, S={S}, N={N}, H={H}, {q.dtype})")
    kernel.launches += 1


def _flash_forward_lse_cuda(q, k, v, *, causal):
    """Launch ``csrc/flash_fwd.cu``."""
    B, S, N, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B * N, S), dtype=torch.float32, device=q.device)
    _launch(_kernels.FLASH_FWD, {"q": q, "k": k, "v": v}, {}, causal,
            {"o": o, "lse": lse})
    return o, lse


def _flash_dq_cuda(q, k, v, do, lse, d, *, causal):
    """Launch ``csrc/flash_bwd_dq.cu``."""
    dq = torch.empty_like(q)
    _launch(_kernels.FLASH_DQ, {"q": q, "k": k, "v": v, "do": do},
            {"lse": lse, "d": d}, causal, {"dq": dq})
    return dq


def _flash_dkv_cuda(q, k, v, do, lse, d, *, causal):
    """Launch ``csrc/flash_bwd_dkv.cu``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_kernels.FLASH_DKV, {"q": q, "k": k, "v": v, "do": do},
            {"lse": lse, "d": d}, causal, {"dk": dk, "dv": dv})
    return dk, dv


# ---- public API -----------------------------------------------------------

@torch.library.custom_op("tputopo::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _flash_forward_lse_plain(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return _flash_forward_lse_cuda(q, k, v, causal=causal)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    B, S, N, _ = q.shape
    return torch.empty_like(q), q.new_empty((B * N, S), dtype=torch.float32)


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block_q: int = 512,
                      block_kv: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v ``[B, S, N, H]`` -> (O ``[B, S, N, H]`` in q's dtype,
    LSE ``[B*N, S]`` f32), not differentiable (the reference's primitive).

    ``block_q``/``block_kv`` keep the reference's shape contract (S
    divisible by both; causal needs them equal) so the two APIs accept
    and reject the same calls; the CUDA kernels pick their own tiles."""
    _validate(q, k, v, causal, block_q, block_kv)
    return torch.ops.tputopo.flash_fwd(*_dense(q, k, v), causal)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool = True, block_q: int = 512, block_kv: int = 512
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of attention at the cotangent ``do``, from the forward's
    O and LSE.  D = rowsum(dO∘O) is taken here in f32, as the reference's
    ``_flash_backward`` does outside its kernels."""
    _validate(q, k, v, causal, block_q, block_kv)
    if do.shape != q.shape or o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    # autograd may hand a non-contiguous or expanded (stride-0) cotangent
    q, k, v, o, lse, do = _dense(q, k, v, o, lse, do)
    d = _flash_d(o, do)
    if q.device.type == "cpu":
        dq = _flash_dq_plain(q, k, v, do, lse, d, causal=causal)
        dk, dv = _flash_dkv_plain(q, k, v, do, lse, d, causal=causal)
    elif q.device.type == "cuda":
        dq = _flash_dq_cuda(q, k, v, do, lse, d, causal=causal)
        dk, dv = _flash_dkv_cuda(q, k, v, do, lse, d, causal=causal)
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_vjp``: forward kernel, residuals
    ``(q, k, v, o, lse)``, backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        q, k, v = _dense(q, k, v)
        o, lse = torch.ops.tputopo.flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, block_q, block_kv = ctx.blocks
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, causal=causal,
                                    block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """q/k/v ``[B, S, N, H]`` -> O ``[B, S, N, H]`` in q's dtype;
    differentiable in q, k and v."""
    _validate(q, k, v, causal, block_q, block_kv)
    return _FlashAttention.apply(q, k, v, causal, block_q, block_kv)


def reference_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Einsum reference (the model's path), for kernel verification."""
    probs = torch.softmax(_scores(q, k, causal=causal), dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs, v.float()).to(q.dtype)
