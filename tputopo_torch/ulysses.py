"""All-to-all (Ulysses-style) sequence parallelism over the ``sp`` axis — the
counterpart of ``tputopo/workloads/ulysses.py``.

The second context-parallel strategy next to :mod:`.ring`, with the same
per-rank contract (swappable by ``ModelConfig.sp_impl``).  Where ring
attention rotates K/V chunks ``sp - 1`` times a layer, this strategy
re-shards once each way: an all-to-all turns the sequence split into a
head split (each rank then holds the whole sequence for ``N / (tp * sp)``
heads), attention runs locally over the whole sequence (the port's flash
kernels on a CUDA device), and a second all-to-all restores the sequence
split.  It needs ``sp`` to divide the local head counts, GQA's K/V
included.

Each all-to-all is ``all_to_all_single`` over the ``sp`` group
(:func:`~.sharding.all_to_all`) on a layout that reproduces JAX's tiled
``all_to_all(split_axis=2, concat_axis=1)``: head group ``j`` goes to rank
``j``, and the sequence chunks arrive in rank order; the way back is the
reverse.  The all-to-all is its own adjoint, so one autograd function
carries it both ways.
"""

from __future__ import annotations

import torch

from tputopo_torch import attention
from tputopo_torch.sharding import all_to_all


def _flash_block(S: int) -> int:
    """The block size the local flash call uses: the kernels' full-size
    blocks where they divide, else the largest fallback (the chain of the
    reference's ``model._flash_dispatch``)."""
    for b in (512, 256):
        if S % b == 0:
            return b
    return min(128, S)


def _flash_shapes_ok(S: int) -> bool:
    block = _flash_block(S)
    return S >= 16 and S % block == 0 and block % 8 == 0


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 of ``[sp, ...]`` blocks, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def _seq_to_heads(x: torch.Tensor, plan, axis: str) -> torch.Tensor:
    """[B, Sc, Nl, H] -> [B, S, Nl/sp, H]: heads scatter, sequence gathers."""
    B, Sc, Nl, H = x.shape
    sp = plan.size(axis)
    blocks = x.reshape(B, Sc, sp, Nl // sp, H).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(blocks, plan.group(axis))  # [sp (chunk), B, Sc, Nh, H]
    return got.permute(1, 0, 2, 3, 4).reshape(B, sp * Sc, Nl // sp, H)


def _heads_to_seq(x: torch.Tensor, plan, axis: str) -> torch.Tensor:
    """[B, S, Nl/sp, H] -> [B, Sc, Nl, H]: sequence scatters, heads gather."""
    B, S, Nh, H = x.shape
    sp = plan.size(axis)
    blocks = x.reshape(B, sp, S // sp, Nh, H).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(blocks, plan.group(axis))  # [sp (head group), B, Sc, Nh, H]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // sp, sp * Nh, H)


def a2a_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        plan, axis_name: str = "sp", causal: bool = True,
                        kv_group: int = 1, impl: str = "einsum") -> torch.Tensor:
    """Per-rank body: q [B, Sc, Nl, H], k/v [B, Sc, Nl/kv_group, H] local
    chunks; returns the local [B, Sc, Nl, H] as if attention ran over the
    whole sequence.  Needs ``sp`` to divide ``Nl`` and ``Nl / kv_group``
    (checked by :func:`a2a_attention`)."""
    qg, kg, vg = (_seq_to_heads(t, plan, axis_name) for t in (q, k, v))
    if kv_group > 1:
        kg = kg.repeat_interleave(kv_group, dim=2)
        vg = vg.repeat_interleave(kv_group, dim=2)
    if impl == "flash":
        blk = _flash_block(qg.shape[1])
        out = attention.flash_attention(qg, kg, vg, causal=causal, block_q=blk,
                                        block_kv=blk)
    else:
        out = attention.reference_attention(qg, kg, vg, causal=causal)
    return _heads_to_seq(out, plan, axis_name)


def a2a_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan, *,
                  causal: bool = True, kv_group: int = 1,
                  impl: str = "auto") -> torch.Tensor:
    """Per-rank entry under ``plan``, the contract of
    :func:`~.ring.ring_attention`: q [B, Sc, N/tp, H] this rank's block
    (k/v may carry 1/kv_group of its heads).

    ``impl``: "flash" runs the flash kernels on the whole-sequence local
    block (their plain versions on the CPU), "einsum" the reference block,
    "auto" flash on a CUDA device whenever the sequence and the head dim
    allow it."""
    n_sp = plan.size("sp")
    n_local, nkv_local = q.shape[2], k.shape[2]
    if n_local % n_sp or nkv_local % n_sp:
        raise ValueError(
            f"a2a sequence parallelism needs sp={n_sp} to divide the local "
            f"head counts (q {n_local}, kv {nkv_local}); expand GQA heads "
            "or use the ring strategy")
    if impl == "auto":
        impl = ("flash" if q.device.type == "cuda"
                and _flash_shapes_ok(q.shape[1] * n_sp)
                and attention.head_dim_ok(q.shape[3]) else "einsum")
    return a2a_attention_local(q, k, v, plan=plan, causal=causal,
                               kv_group=kv_group, impl=impl)
