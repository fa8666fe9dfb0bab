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

Attention over a KV cache, :func:`cached_attention`, has two kernels,
where the reference leaves plain einsums to XLA: ``csrc/decode_attn.cu``
(:func:`_decode_attention_cuda`) for a few queries a row, the decode and
speculative steps, and ``csrc/chunk_attn.cu`` (:func:`_chunk_attention_cuda`)
for wider blocks, the prefill chunks and admissions.
:func:`decode_kernel_takes` and :func:`chunk_kernel_takes` say which calls
take them, in that order; the rest (an int8 cache, an f32 model, the CPU)
run :func:`cached_attention_plain`, their plain version.  Neither takes a
latent cache: latent attention (MLA, :mod:`.mla`) over its own cache is
:func:`cached_latent_attention`, two forms in plain PyTorch (bf16 products,
an online softmax over blocks of positions): :func:`latent_absorbed` for
decode steps, :func:`latent_expanded` for prefill chunks.

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

import contextlib

import torch

from tputopo_torch import _graphs, _kernels
from tputopo_torch.quant import fold_kv_scale

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


def head_dim_ok(h: int) -> bool:
    """Whether the kernels take head dim ``h`` (a multiple of 8 in [8, 128]):
    the rule by which an "auto" path picks them on a CUDA device."""
    return h % 8 == 0 and 8 <= h <= 128


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


def _call(kernel: _kernels.Kernel, args: tuple, device, what: str) -> None:
    """Call ``kernel``'s C entry with ``args`` on the current stream of
    ``device``, raise if it returns an error (``what`` names the call), and
    count the launch: in ``launches``, or in ``captured`` while a CUDA graph
    capture records it (its replays count it, :mod:`._graphs`)."""
    with torch.cuda.device(device):
        err = kernel.entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError {err} ({what})")
    _count(kernel, device)


def _count(kernel: _kernels.Kernel, device) -> None:
    """Count one launch of ``kernel`` on ``device``: in ``captured`` while a
    CUDA graph capture records it, else in ``launches``."""
    if _graphs.capturing(device):
        kernel.captured += 1
    else:
        kernel.launches += 1


def _launch(kernel: _kernels.Kernel, tensors: dict, rows: dict, causal: bool,
            outputs: dict):
    """Launch a flash kernel on the current stream (:func:`_call`)."""
    args = _launch_args(kernel, tensors, rows, causal, outputs)
    q = tensors["q"]
    B, S, N, H = q.shape
    _call(kernel, args, q.device, f"B={B}, S={S}, N={N}, H={H}, {q.dtype}")


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


# ---- attention over a KV cache ----------------------------------------------
#
# ``csrc/decode_attn.cu`` computes :func:`cached_attention` over a bf16 cache
# for few queries a row, ``csrc/chunk_attn.cu`` for the rest;
# :func:`cached_attention_plain` is their plain version.

DECODE_SPLIT = 256              # cache positions per block: ``SPLIT`` in the source
DECODE_MAX_QUERIES = 64         # T * group queries per KV head: ``MAX_Q``
DECODE_HEAD_DIM = 128           # ``HEAD_DIM``
CHUNK_ROWS = 128                # query rows a block, group * positions: ``ROWS``
CHUNK_HEAD_DIM = 128            # ``HEAD_DIM``


def decode_kernel_fits(T: int, group: int, H: int) -> bool:
    """Whether the decode-attention kernel takes T queries per slot, GQA
    ``group`` and head dim ``H``."""
    return T * group <= DECODE_MAX_QUERIES and H == DECODE_HEAD_DIM


def decode_kernel_takes(q: torch.Tensor, ck: torch.Tensor,
                        ck_s: torch.Tensor | None, group: int) -> bool:
    """Whether :func:`cached_attention` sends the call to the decode-attention
    kernel: CUDA tensors, a bf16 cache (no int8 scales) and bf16 queries, at
    most 16 queries per row (the decode step and the speculative draft, 1;
    the verify block, gamma + 1; wider calls, the prefills, keep the
    einsums), and a group and head dim the kernel takes."""
    T, H = q.shape[1], q.shape[3]
    return (q.device.type == "cuda" and ck_s is None and len(ck.shape) == 4
            and ck.dtype == q.dtype == torch.bfloat16 and T <= 16
            and decode_kernel_fits(T, group, H))


def chunk_kernel_fits(group: int, H: int) -> bool:
    """Whether the chunk-attention kernel takes GQA ``group`` and head dim
    ``H``: the group's heads of one KV head fit a block's query rows."""
    return 1 <= group <= CHUNK_ROWS and H == CHUNK_HEAD_DIM


def chunk_kernel_takes(q: torch.Tensor, ck: torch.Tensor,
                       ck_s: torch.Tensor | None, group: int) -> bool:
    """Whether the chunk-attention kernel can take a call to
    :func:`cached_attention` (which asks :func:`decode_kernel_takes` first):
    CUDA tensors, a bf16 cache (no int8 scales) and bf16 queries, N a
    multiple of the cache's KV heads, and a group and head dim the kernel
    takes; any number of queries a row."""
    N, H = q.shape[2], q.shape[3]
    return (q.device.type == "cuda" and ck_s is None and len(ck.shape) == 4
            and ck.dtype == q.dtype == torch.bfloat16
            and N == group * ck.shape[2] and chunk_kernel_fits(group, H))


def cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, group: int,
                     ck_s: torch.Tensor | None = None,
                     cv_s: torch.Tensor | None = None) -> torch.Tensor:
    """T queries per row, each row at its OWN base position: q [B, T, N, H]
    against one layer's cache [B, S, KV, H]; row b's query t sits at
    pos[b] + t and attends cache positions <= it -> [B, T, N, H].  An int8
    cache passes its scale buffers ``ck_s``/``cv_s`` [B, S, KV, 1].  The
    decode-attention kernel where :func:`decode_kernel_takes` the call, else
    the chunk-attention kernel where :func:`chunk_kernel_takes` it, both of
    which read the cache in place and only up to each row's position;
    :func:`cached_attention_plain` otherwise."""
    if decode_kernel_takes(q, ck, ck_s, group):
        return _decode_attention_cuda(q, ck, cv, pos)
    if chunk_kernel_takes(q, ck, ck_s, group):
        return _chunk_attention_cuda(q, ck, cv, pos)
    return cached_attention_plain(q, ck, cv, pos, group, ck_s, cv_s)


def cached_attention_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           pos: torch.Tensor, group: int,
                           ck_s: torch.Tensor | None = None,
                           cv_s: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`cached_attention` as the reference's einsums over the whole
    cache, masked with -1e30: the plain version of both cache-attention
    kernels.

    GQA stays grouped: q reshapes to [B, T, KV, group, H], so head n reads
    kv head n // group (the repeat order of the forward) and the cache is
    read at its own KV width.  An int8 cache folds its per-key-position
    scale into the logits and its per-value-position scale into the
    probabilities, both exact."""
    B, T, N, H = q.shape
    KV = ck.shape[2]
    scale = 1.0 / (H ** 0.5)
    qg = q.float().reshape(B, T, KV, group, H) * scale
    s = torch.einsum("btkgh,bskh->bkgts", qg, ck.float())
    if ck_s is not None:
        s = s * fold_kv_scale(ck_s)
    k_pos = torch.arange(ck.shape[1], device=q.device)
    q_pos = pos[:, None] + torch.arange(T, device=q.device)  # [B, T]
    s = torch.where(k_pos <= q_pos[:, None, None, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if cv_s is not None:
        p = p * fold_kv_scale(cv_s)
    out = torch.einsum("bkgts,bskh->btkgh", p, cv.float())
    return out.reshape(B, T, N, H).to(q.dtype)


# ---- latent attention (MLA) over a latent cache -----------------------------
#
# A latent cache row is one token's [c_kv, k_pe] (:mod:`.mla`), read in place
# by both forms, a block of positions at a time, with an online softmax.  The
# absorbed form attends it as one key/value head that every query head
# shares; the expanded form up-projects each block of rows into each head's
# keys and values as it reads the block.

LATENT_ABSORBED_T = 16         # queries a row at most that take the absorbed form
LATENT_BLOCK = 4096            # cache positions a block of the absorbed form
LATENT_EXPANDED_BLOCK = 1024   # cache positions a block of the expanded form

# The counts the latent attention adds to (:func:`latent_counting`); None: it
# counts nothing and adds no operation.
_LATENT = None
_graphs.AMBIENT.append(lambda: None if _LATENT is None else _LATENT.values)


@contextlib.contextmanager
def latent_counting(counts):
    """Within the block, latent attention adds to ``counts`` (an
    :class:`~.obs.LatentCounts`; None: to nothing), in the captured programs
    as :func:`~.moe.counting` does for the expert layer."""
    global _LATENT
    before, _LATENT = _LATENT, counts
    try:
        yield
    finally:
        _LATENT = before


def cached_latent_attention(q_nope: torch.Tensor, q_pe: torch.Tensor,
                            latent: torch.Tensor, pos: torch.Tensor, kv_b,
                            m, span: int | None = None) -> torch.Tensor:
    """Latent attention over one layer's latent cache: queries q_nope
    [B, T, N, nope] and q_pe [B, T, N, rope] (rotated), row b's query t at
    pos[b] + t attending the cache rows latent [B, S, kv_rank + rope] at
    positions <= it; ``kv_b`` [kv_rank, N (nope + v)] the up-projection of
    :class:`~.mla.MLAConfig` ``m`` -> [B, T, N, v].

    ``span`` (a host int; None: S) is a bound the caller knows when the
    program is built, a prefill chunk's start + T: every query attends no
    row at or past it, and every row below span - T.  The forms then read
    the rows below ``span`` only, and mask only the blocks that reach past
    span - T.  A decode step's positions differ by slot and are read on
    the device, so its forms read all S rows.

    T <= :data:`LATENT_ABSORBED_T` (decode steps) takes the absorbed form,
    :func:`latent_absorbed`: 2 N (2 kv_rank + rope) flops a (query,
    position) pair and no up-projection, against 2 N (nope + rope + v) a
    pair plus 2 kv_rank N (nope + v) a row up-projected for the expanded
    form, :func:`latent_expanded`, which the wider prefill chunks take (at
    T 2048, 3.4 times fewer flops a pair).  Neither builds a score tile over
    the whole cache for many queries."""
    T = q_nope.shape[1]
    S = latent.shape[1]
    rows, seen = (latent, 0) if span is None else (latent[:, :span], max(span - T, 0))
    absorbed = T <= LATENT_ABSORBED_T
    counts = _LATENT
    if counts is not None:
        counts.clock(absorbed, -1)
    form = latent_absorbed if absorbed else latent_expanded
    out = form(q_nope, q_pe, rows, pos, kv_b, m, seen)
    if counts is not None:
        counts.add(absorbed, pos, T, S)
        counts.clock(absorbed, 1)
    return out


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product of compute-dtype operands, accumulated and
    returned in f32 (the bf16 operands' products are exact in f32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _online_softmax(block, qpos: torch.Tensor, S: int, size: int, seen: int) -> torch.Tensor:
    """softmax(scores) @ values over key positions 0..S-1 in blocks of
    ``size`` with a running max and sum: ``block(s0, s1)`` gives the block's
    scaled f32 scores [G, M, s1 - s0] (the tile is reused in place) and its
    values [G, s1 - s0, Dv]; query row r attends positions <= qpos[.., r]
    ([G or 1, M]), every row attends the positions below ``seen``, whose
    blocks go unmasked -> [G, M, Dv] f32.  The probabilities are rounded
    once, to the values' dtype, as the exponential writes them, and both
    the product and the running sum take the rounded ones."""
    m_run = l_run = acc = None
    for s0 in range(0, S, size):
        s1 = min(S, s0 + size)
        s, vb = block(s0, s1)
        if s1 > seen:
            s.masked_fill_(torch.arange(s0, s1, device=s.device) > qpos[..., None], NEG_INF)
        top = s.amax(-1, keepdim=True)
        m_new = top if m_run is None else torch.maximum(m_run, top)
        p = torch.exp(s.sub_(m_new), out=torch.empty(s.shape, dtype=vb.dtype, device=s.device))
        pv = _mm_f32(p, vb)
        ps = p.sum(-1, keepdim=True, dtype=torch.float32)
        if m_run is None:
            acc, l_run = pv, ps
        else:
            alpha = torch.exp(m_run - m_new)
            acc = acc.mul_(alpha).add_(pv)
            l_run = l_run.mul_(alpha).add_(ps)
        m_run = m_new
    return acc / l_run


def _up_weights(kv_b, m, N: int, dtype):
    """``kv_b`` at ``dtype`` as (W_uk [kv_rank, N, nope], W_uv [kv_rank, N, v])."""
    w = kv_b.to(dtype).reshape(m.kv_rank, N, m.nope + m.v)
    return w[..., :m.nope], w[..., m.nope:]


def latent_absorbed(q_nope, q_pe, latent, pos, kv_b, m, seen: int = 0) -> torch.Tensor:
    """The absorbed form: each query head's ``q_nope W_uk^T`` (kv_rank wide,
    the softmax scale folded in before its one rounding) beside its q_pe
    attends the cache rows as one shared key head of kv_rank + rope
    features, whose first kv_rank are the shared values, over blocks of
    :data:`LATENT_BLOCK` positions; ``W_uv`` maps each head's latent output
    to its values."""
    from tputopo_torch.mla import softmax_scale

    B, T, N, _ = q_nope.shape
    R = m.kv_rank
    dt = q_nope.dtype
    w_uk, w_uv = _up_weights(kv_b, m, N, dt)
    scale = softmax_scale(m)
    q_abs = torch.einsum("btnd,rnd->btnr", q_nope.float(), w_uk.float()) * scale
    qa = torch.cat([q_abs, q_pe.float() * scale], dim=-1).to(dt).reshape(B, T * N, -1)
    qpos = (pos[:, None] + torch.arange(T, device=pos.device)).repeat_interleave(N, dim=1)

    def block(s0, s1):
        rows = latent[:, s0:s1]
        return _mm_f32(qa, rows.transpose(1, 2)), rows[..., :R]

    o = _online_softmax(block, qpos, latent.shape[1], LATENT_BLOCK, seen)
    return torch.einsum("btnr,rnv->btnv", o.to(dt).reshape(B, T, N, R), w_uv)


def latent_expanded(q_nope, q_pe, latent, pos, kv_b, m, seen: int = 0) -> torch.Tensor:
    """The expanded form: per row b and over blocks of
    :data:`LATENT_EXPANDED_BLOCK` positions, the block's c_kv up-projected by
    ``kv_b`` into each head's k_nope and values, the shared k_pe beside
    them; each head's [q_nope, q_pe] (the softmax scale folded in before its
    one rounding, as the absorbed form folds it) attends them -> [B, T, N,
    v] at the queries' dtype."""
    from tputopo_torch.mla import softmax_scale

    B, T, N, _ = q_nope.shape
    R = m.kv_rank
    w = kv_b.to(latent.dtype)
    scale = softmax_scale(m)
    outs = []
    for b in range(B):
        q = (torch.cat([q_nope[b], q_pe[b]], dim=-1).float() * scale).to(q_nope.dtype)
        q = q.transpose(0, 1)                                                 # [N, T, Dk]
        qpos = (pos[b] + torch.arange(T, device=pos.device))[None]

        def block(s0, s1, b=b, q=q):
            rows = latent[b, s0:s1]
            kv = (rows[:, :R] @ w).reshape(s1 - s0, N, m.nope + m.v)
            k = torch.cat([kv[..., :m.nope],
                           rows[:, None, R:].expand(-1, N, -1)], dim=-1)      # [n, N, Dk]
            return _mm_f32(q, k.permute(1, 2, 0)), kv[..., m.nope:].transpose(0, 1)

        o = _online_softmax(block, qpos, latent.shape[1], LATENT_EXPANDED_BLOCK, seen)
        outs.append(o.transpose(0, 1))
    return torch.stack(outs).to(q_nope.dtype)


def _check_cache_operands(what: str, q, ck, cv, pos, outputs: dict) -> tuple[int, int]:
    """The checks both cache-attention kernels need of q [B, T, N, H], the
    cache layer ck, cv [B, S, KV, H], pos [B] int64 and ``outputs``: shapes
    that agree, N a multiple of KV, every tensor on q's device, contiguous
    and on a 16-byte boundary (the chunk kernel's TMA needs both), and q,
    the cache and ``outputs["out"]`` bf16 -> (S, KV).  ``what`` names the
    kernel in the errors."""
    B, T, N, H = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != H or cv.shape != ck.shape:
        raise ValueError(f"{what} takes a cache layer [{B}, S, KV, {H}] for q "
                         f"{tuple(q.shape)}, got {tuple(ck.shape)} and {tuple(cv.shape)}")
    S, KV = ck.shape[1], ck.shape[2]
    if N % KV:
        raise ValueError(f"{N} query heads are not a multiple of {KV} KV heads")
    for name, t in {"q": q, "ck": ck, "cv": cv, **outputs}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    for name, t in {"q": q, "ck": ck, "cv": cv, "out": outputs["out"]}.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} takes bfloat16, {name} is {t.dtype}")
    if (pos.device != q.device or pos.dtype != torch.int64 or pos.shape != (B,)
            or not pos.is_contiguous()):
        raise ValueError(f"pos must be a contiguous int64 [{B}] tensor on {q.device}")
    return S, KV


def _decode_launch_args(q, ck, cv, pos, outputs: dict) -> tuple:
    """Check the arguments of ``csrc/decode_attn.cu``'s C entry and return
    them, the stream aside: the pointers of q [B, T, N, H], the cache layer
    ck, cv [B, S, KV, H] (all bf16), pos [B] int64 and ``outputs`` (out,
    part_acc, part_ml), then B, T, S, N, KV, H and the softmax scale."""
    B, T, N, H = q.shape
    S, KV = _check_cache_operands("decode attention", q, ck, cv, pos, outputs)
    if not decode_kernel_fits(T, N // KV, H):
        raise ValueError(f"decode attention takes T * group <= {DECODE_MAX_QUERIES} and "
                         f"head dim {DECODE_HEAD_DIM}, got T={T}, group={N // KV}, H={H}")
    n_splits, Q = -(-S // DECODE_SPLIT), T * (N // KV)
    want = {"out": (q.shape, torch.bfloat16),
            "part_acc": ((B, KV, n_splits, Q, H), torch.float32),
            "part_ml": ((B, KV, n_splits, Q, 2), torch.float32)}
    for name, (shape, dtype) in want.items():
        t = outputs[name]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}")
    ptrs = [t.data_ptr() for t in (q, ck, cv, pos, *(outputs[n] for n in want))]
    return (*ptrs, B, T, S, N, KV, H, 1.0 / (H ** 0.5))


def _decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/decode_attn.cu``: q [B, T, N, H] against one layer's
    bf16 cache ck, cv [B, S, KV, H], read in place; slot b's query t sits
    at pos[b] + t -> out [B, T, N, H] bf16, as :func:`cached_attention_plain`."""
    B, T, N, H = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    splits = (B, KV, -(-S // DECODE_SPLIT), T * (N // KV))
    outputs = {"out": torch.empty_like(q),
               "part_acc": torch.empty((*splits, H), dtype=torch.float32, device=q.device),
               "part_ml": torch.empty((*splits, 2), dtype=torch.float32, device=q.device)}
    _call(_kernels.DECODE_ATTN, _decode_launch_args(q, ck, cv, pos, outputs), q.device,
          f"B={B}, T={T}, S={S}, N={N}, KV={KV}, H={H}")
    return outputs["out"]


def _chunk_launch_args(q, ck, cv, pos, out) -> tuple:
    """Check the arguments of ``csrc/chunk_attn.cu``'s C entry and return
    them, the stream aside: the pointers of q [B, T, N, H], the cache layer
    ck, cv [B, S, KV, H], pos [B] int64 and out [B, T, N, H] (all bf16 but
    pos), then B, T, S, N, KV, H and the softmax scale."""
    B, T, N, H = q.shape
    S, KV = _check_cache_operands("chunk attention", q, ck, cv, pos, {"out": out})
    if not chunk_kernel_fits(N // KV, H):
        raise ValueError(f"chunk attention takes a group of at most {CHUNK_ROWS} and head "
                         f"dim {CHUNK_HEAD_DIM}, got group={N // KV}, H={H}")
    if out.shape != q.shape:
        raise ValueError(f"out must be {tuple(q.shape)}, got {tuple(out.shape)}")
    ptrs = [t.data_ptr() for t in (q, ck, cv, pos, out)]
    return (*ptrs, B, T, S, N, KV, H, 1.0 / (H ** 0.5))


def _chunk_attention_cuda(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chunk_attn.cu``: q [B, T, N, H] against one layer's
    bf16 cache ck, cv [B, S, KV, H], read in place up to each block's last
    query; row b's query t sits at pos[b] + t -> out [B, T, N, H] bf16, as
    :func:`cached_attention_plain` with P rounded to bf16 before P·V."""
    B, T, N, H = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    out = torch.empty_like(q)
    _call(_kernels.CHUNK_ATTN, _chunk_launch_args(q, ck, cv, pos, out), q.device,
          f"B={B}, T={T}, S={S}, N={N}, KV={KV}, H={H}")
    return out


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
