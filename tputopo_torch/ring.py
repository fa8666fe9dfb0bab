"""Ring attention — context parallelism over the ``sp`` mesh axis, the
counterpart of ``tputopo/workloads/ring.py``.

With the sequence split over the ``sp`` ranks, each rank keeps its chunk
of Q and rotates the K/V chunks around the ring, one point-to-point hop a
step, merging the partial results with the online-softmax recurrence: peak
memory O(S / sp) per rank, the math that of full attention.  Causality
masks by global position from each chunk's ring offset.  GQA: the narrow
K/V (``kv_group`` > 1) is what rotates, expanded at compute time.

Two local bodies, as in the reference:

- :func:`ring_attention_local`, the einsum body, differentiable through
  autograd: each rotation is one autograd node (:class:`_RotateKV`) whose
  backward sends the gradient back the way the chunk came.
- :func:`ring_flash_attention_local`, the flash body, one
  ``torch.autograd.Function``: the port's flash kernels (:mod:`.attention`)
  on each chunk (the diagonal chunk causal, an earlier one in full, a
  later one skipped with no launch), partials merged by ``logaddexp`` of
  their LSEs.  Its hand-written backward rotates K/V and the dK/dV
  accumulators ``n`` times, so each accumulator arrives home, and runs the
  backward kernels from the MERGED O and LSE: with the global LSE each
  chunk's P is the global softmax's, and D = rowsum(dO∘O) needs the global
  O.

Rotation is ``batch_isend_irecv`` over the ``sp`` group
(:func:`~.sharding.exchange`).  Every rank runs the same sequence of
rotations, forward and backward, so the sends and receives pair up.
"""

from __future__ import annotations

import torch

from tputopo_torch import attention
from tputopo_torch.sharding import exchange

NEG_INF = -1e30
_RING_FLASH_BLOCK = 256
DIAG, FULL, SKIP = 0, 1, 2


def _rotate(plan, axis: str, tensors) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``axis``, its counterpart
    received from the previous one."""
    r = plan.rank(axis)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    exchange(plan, axis, [(t, r + 1) for t in tensors], [(b, r - 1) for b in out])
    return out


class _RotateKV(torch.autograd.Function):
    """One ring step of the K/V pair: to the next rank forward, the
    gradients back to the previous rank backward."""

    @staticmethod
    def forward(ctx, k, v, plan, axis):
        ctx.plan, ctx.axis = plan, axis
        return tuple(_rotate(plan, axis, (k, v)))

    @staticmethod
    def backward(ctx, gk, gv):
        plan, axis = ctx.plan, ctx.axis
        r = plan.rank(axis)
        out = [torch.empty_like(g, memory_format=torch.contiguous_format) for g in (gk, gv)]
        exchange(plan, axis, [(gk, r - 1), (gv, r - 1)], [(b, r + 1) for b in out])
        return out[0], out[1], None, None


def _expand_kv(x: torch.Tensor, kv_group: int) -> torch.Tensor:
    return x.repeat_interleave(kv_group, dim=2) if kv_group > 1 else x


def _reduce_kv(dx: torch.Tensor, kv_group: int) -> torch.Tensor:
    if kv_group == 1:
        return dx
    B, Sc, N, H = dx.shape
    return dx.reshape(B, Sc, N // kv_group, kv_group, H).sum(dim=3)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         plan, axis_name: str = "sp", causal: bool = True,
                         kv_group: int = 1) -> torch.Tensor:
    """Per-rank einsum body: q [B, Sc, N, H], k/v [B, Sc, N/kv_group, H]
    local chunks; returns the local [B, Sc, N, H] attention output as if
    computed over the whole sequence.  ``n - 1`` rotations for ``n`` chunks."""
    B, Sc, N, H = q.shape
    n, my = plan.size(axis_name), plan.rank(axis_name)
    qf = q.float() * (1.0 / H ** 0.5)
    q_pos = my * Sc + torch.arange(Sc, device=q.device)
    m = torch.full((B, N, Sc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, N, Sc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sc, N, H), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for j in range(n):
        kcf = _expand_kv(kc.float(), kv_group)
        vcf = _expand_kv(vc.float(), kv_group)
        src = (my - j) % n  # the ring position this chunk came from
        s = torch.einsum("bqnh,bknh->bnqk", qf, kcf)
        if causal:
            k_pos = src * Sc + torch.arange(Sc, device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        # alpha is [B, N, Sc, 1]; acc is [B, Sc, N, H]
        acc = acc * alpha.transpose(1, 2) + torch.einsum("bnqk,bknh->bqnh", p, vcf)
        m = m_new
        if j < n - 1:
            kc, vc = _RotateKV.apply(kc, vc, plan, axis_name)
    # a fully masked row cannot occur when causal includes self; guard anyway
    return (acc / l.transpose(1, 2).clamp_min(1e-30)).to(q.dtype)


def _chunk_case(my: int, src: int, causal: bool) -> int:
    """DIAG (within-chunk causal), FULL (fully visible) or SKIP (invisible)."""
    if not causal:
        return FULL
    return DIAG if src == my else FULL if src < my else SKIP


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom VJP: the forward ring of flash
    forwards, residuals (q, k, v, merged O, merged LSE), and a second ring
    of flash backwards."""

    @staticmethod
    def forward(ctx, q, k, v, plan, axis, causal, kv_group, block):
        B, Sc, N, H = q.shape
        n, my = plan.size(axis), plan.rank(axis)
        out_run = torch.zeros((B, Sc, N, H), dtype=torch.float32, device=q.device)
        lse_run = torch.full((B, N, Sc), NEG_INF, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for j in range(n):
            case = _chunk_case(my, (my - j) % n, causal)
            if case != SKIP:
                o_j, lse_j = attention.flash_forward_lse(
                    q, _expand_kv(kc, kv_group), _expand_kv(vc, kv_group),
                    causal=case == DIAG, block_q=block, block_kv=block)
                lse_j = lse_j.reshape(B, N, Sc)
                new = torch.logaddexp(lse_run, lse_j)
                # [B, N, Sc] weights -> [B, Sc, N, 1] to scale the output
                out_run = (out_run * torch.exp(lse_run - new).transpose(1, 2)[..., None]
                           + o_j.float() * torch.exp(lse_j - new).transpose(1, 2)[..., None])
                lse_run = new
            if j < n - 1:
                kc, vc = _rotate(plan, axis, (kc, vc))
        out = out_run.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_run)
        ctx.args = (plan, axis, causal, kv_group, block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k0, v0, out, lse_run = ctx.saved_tensors
        plan, axis, causal, kv_group, block = ctx.args
        B, Sc, N, H = q.shape
        n, my = plan.size(axis), plan.rank(axis)
        lse = lse_run.reshape(B * N, Sc)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k0.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v0.shape, dtype=torch.float32, device=q.device)
        kc, vc = k0, v0
        for j in range(n):
            case = _chunk_case(my, (my - j) % n, causal)
            if case != SKIP:
                dq_j, dk_j, dv_j = attention.flash_backward(
                    q, _expand_kv(kc, kv_group), _expand_kv(vc, kv_group), out, lse,
                    do, causal=case == DIAG, block_q=block, block_kv=block)
                dq += dq_j.float()
                dk += _reduce_kv(dk_j, kv_group).float()
                dv += _reduce_kv(dv_j, kv_group).float()
            # The accumulators rotate every step (n in all): each chunk's
            # gradient completes the cycle and lands back on its owner.
            if j < n - 1:
                kc, vc, dk, dv = _rotate(plan, axis, (kc, vc, dk, dv))
            elif n > 1:
                dk, dv = _rotate(plan, axis, (dk, dv))
        return (dq.to(q.dtype), dk.to(k0.dtype), dv.to(v0.dtype),
                None, None, None, None, None)


def ring_flash_attention_local(q, k, v, *, plan, axis_name: str = "sp",
                               causal: bool = True, kv_group: int = 1,
                               block: int = _RING_FLASH_BLOCK) -> torch.Tensor:
    """Flash per-rank ring body, the contract of :func:`ring_attention_local`
    with an O(block^2) working set: the port's kernels on a CUDA device,
    their plain versions on the CPU."""
    block = min(block, q.shape[1])
    return _RingFlash.apply(q, k, v, plan, axis_name, causal, kv_group, block)


def _flash_shapes_ok(Sc: int) -> bool:
    """Check against the block the flash path will run with
    (:func:`ring_flash_attention_local` clips its default to min(256, Sc))."""
    b = min(_RING_FLASH_BLOCK, Sc)
    return Sc >= 16 and Sc % b == 0 and b % 8 == 0


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan, *,
                   causal: bool = True, kv_group: int = 1,
                   impl: str = "auto") -> torch.Tensor:
    """Per-rank entry under ``plan``: q [B, Sc, N, H] this rank's block of
    the batch, sequence chunk and heads (k/v may carry N / kv_group heads).

    ``impl``: "flash" runs the flash body (the kernels on a CUDA device),
    "einsum" the einsum body, "auto" flash on a CUDA device whenever the
    chunk's shape and the head dim allow it."""
    if impl == "auto":
        impl = ("flash" if q.device.type == "cuda" and _flash_shapes_ok(q.shape[1])
                and attention.head_dim_ok(q.shape[3]) else "einsum")
    if impl == "flash":
        return ring_flash_attention_local(q, k, v, plan=plan, causal=causal,
                                          kv_group=kv_group)
    if impl == "einsum":
        return ring_attention_local(q, k, v, plan=plan, causal=causal,
                                    kv_group=kv_group)
    raise ValueError(f"unknown ring impl {impl!r}")
