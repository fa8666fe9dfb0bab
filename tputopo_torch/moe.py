"""Mixture-of-Experts MLP with expert parallelism over the ``ep`` mesh axis —
the counterpart of ``tputopo/workloads/moe.py``.

Routing is the reference's GShard/Switch capacity-factor formulation: every
(token, slot) is seated into a fixed ``[experts, capacity]`` buffer by
one-hot products, the router in float32, the expert FFN in
``compute_dtype``.  The dispatch and combine are ``torch.einsum`` products,
as the reference computes them outside any kernel.  The Switch auxiliary
loss (fraction routed x mean router probability, scaled by E) comes back
with the output.

Where the reference shards the expert tables over ``ep`` and lets XLA
place the all-to-all at a sharding constraint, the port writes the
collectives out (:func:`moe_mlp`).  Tokens are replicated over ``ep``
(batch over ``dp``, sequence over ``sp``), so each ``ep`` rank dispatches
to its own ``E / ep`` experts, runs their FFN (tensor-parallel inside over
``tp``, as the dense MLP), and combines a partial sum; one all-reduce over
``ep`` completes it.  The pair of :mod:`.model`'s tensor-parallel functions
carries it: identity forward / all-reduce backward on the local part's
inputs, all-reduce forward / identity backward on its output.

The reference computes capacity and the aux statistics over its global
arrays.  The port's ranks hold blocks of them, so it adds what the global
view gave for free: capacity from the global sequence length, seat
positions that continue across ``sp`` chunks (an exclusive prefix sum over
``sp`` of each chunk's per-expert counts), and the aux's two means over the
global ``[B, T]`` (sums all-reduced over ``dp`` and ``sp`` before the
product).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tputopo_torch.model import (all_reduce_f32, copy_to_tp, reduce_from_tp,
                                 resolve_device)
from tputopo_torch.quant import deq, is_quantized, qdot


@dataclass(frozen=True)
class MoEConfig:
    """Expert-layer hyperparameters (attached to ``ModelConfig.moe``)."""

    n_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(tokens_per_group * top_k / n_experts
    #                            * capacity_factor), rounded up to 8;
    # tokens over capacity fall through the residual.
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2

    def capacity(self, group_tokens: int) -> int:
        raw = group_tokens * self.top_k * self.capacity_factor / self.n_experts
        cap = int(-(-raw // 8) * 8)  # ceil to multiple of 8
        return max(8, min(cap, group_tokens))


def init_moe_params(cfg, seed: int = 0, *, device=None, dense=None) -> dict:
    """Per-layer MoE tensors stacked on a leading layer axis, expert axis
    second: router [L, D, E], expert FFN [L, E, D, F] / [L, E, F, D], f32.

    ``dense(name, shape, fan_in)`` draws one leaf; by default N(0, 1/fan_in)
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (:func:`~.model.init_params` passes its own, so a model draws from one
    stream)."""
    m = cfg.moe
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, m.n_experts
    if dense is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def dense(name, shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return w.mul_(1.0 / math.sqrt(fan_in))

    return {  # the dict order is the draw order
        "router": dense("router", (L, D, E), D),
        "w_gate": dense("w_gate", (L, E, D, Fd), D),
        "w_up": dense("w_up", (L, E, D, Fd), D),
        "w_down": dense("w_down", (L, E, Fd, D), Fd),
    }


class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` forward and backward: the adjoint of an all-reduce
    whose result every rank's loss reads, under the step's convention that
    the objective is the sum over ``sp`` and the mean over ``dp`` of the
    ranks' losses (:func:`~.train.sharded_loss_and_grads`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


def _data_axes(plan) -> list[str]:
    """The axes over which the routing group's tokens are split."""
    return [a for a in ("dp", "sp") if plan is not None and plan.size(a) > 1]


def _seats_before(counts: torch.Tensor, plan) -> torch.Tensor:
    """Seats each expert gave to earlier ``sp`` chunks of the same rows:
    the exclusive prefix sum over ``sp`` ranks of ``counts`` [B, E]."""
    from tputopo_torch.sharding import all_gather

    parts = all_gather(counts, plan.group("sp"))
    before = parts[:plan.rank("sp")]
    return torch.stack(before).sum(0) if before else torch.zeros_like(counts)


def _route(x32: torch.Tensor, router: torch.Tensor, m: MoEConfig, plan=None):
    """Top-k routing with capacity assignment.

    x32 [B, T, D] float32 -> (combine [B, T, k, E, C], aux loss scalar).
    ``combine`` carries the gate weight at each (slot, expert, capacity
    position); its support is the dispatch mask.  Under ``plan`` with
    ``sp > 1``, ``T`` is this rank's chunk: capacity counts the whole
    sequence and seats continue from the earlier chunks."""
    B, T, _ = x32.shape
    E, k = m.n_experts, m.top_k
    sp = plan.size("sp") if plan is not None else 1
    C = m.capacity(T * sp)

    probs = torch.softmax(x32 @ router.float(), dim=-1)               # [B,T,E]
    gates, idx = torch.topk(probs, k, dim=-1)                         # [B,T,k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(idx, E).float()                                # [B,T,k,E]
    # Slots claim seats in (token, slot-rank) order: flatten (T, k) so
    # rank-0 slots of earlier tokens win seats first.
    flat = onehot.reshape(B, T * k, E)
    pos = flat.cumsum(1) - flat                                       # seats before me
    if sp > 1:
        pos = pos + _seats_before(flat.sum(1), plan)[:, None, :]
    pos = pos.reshape(B, T, k, E)
    kept = onehot * (pos < C)
    # one_hot(pos, C), all-zero where pos >= C, as jax.nn.one_hot gives
    seat = (pos[..., None] == torch.arange(C, device=x32.device)).float()
    combine = kept[..., None] * seat * gates[..., None, None]         # [B,T,k,E,C]

    # Switch aux: E * mean_e(fraction routed to e) . mean_e(router prob),
    # both means over the global [B, T].
    routed, prob_sum, n = onehot.sum((0, 1, 2)), probs.sum((0, 1)), B * T
    for axis in _data_axes(plan):
        routed = all_reduce_f32(routed, plan.group(axis))
        prob_sum = _AllReduce.apply(prob_sum, plan.group(axis))
        n *= plan.size(axis)
    aux = m.aux_loss_weight * E * torch.sum((routed / n) * (prob_sum / n))
    return combine, aux


def moe_mlp(x: torch.Tensor, p: dict, cfg, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel FFN: x [B, T, D] -> (out [B, T, D], aux loss).

    ``p`` holds ONE layer's slice of the :func:`init_moe_params` tensors,
    this rank's block of them under the active plan (experts over ``ep``,
    ``d_ff`` over ``tp``); ``tp`` is the model's tensor-parallel context.
    Tokens over capacity contribute zero here and survive through the
    residual connection."""
    from tputopo_torch.sharding import active_plan

    m = cfg.moe
    plan = active_plan()
    dt = x.dtype
    combine, aux = _route(x.float(), p["router"], m, plan)
    ep = plan.size("ep") if plan is not None else 1
    if ep > 1:
        if m.n_experts % ep:
            raise ValueError(f"ep={ep} does not divide n_experts={m.n_experts}")
        group, n_local = plan.group("ep"), m.n_experts // ep
        x = copy_to_tp(x, group)
        lo = plan.rank("ep") * n_local
        combine = copy_to_tp(combine, group)[:, :, :, lo:lo + n_local]
    disp = (combine > 0).to(dt)                                       # [B,T,k,E,C]

    # Dispatch: tokens -> [E, B, C, D] (this rank's experts)
    xe = torch.einsum("btkec,btd->ebcd", disp, x)
    if tp is not None:
        xe = copy_to_tp(xe, tp.group)
    # deq (not qdot): the expert products carry an expert batch axis; this
    # is the training path, which keeps f32 masters.
    wg, wu, wd = (deq(p[n], dt) for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, wg))
    h = h * torch.einsum("ebcd,edf->ebcf", xe, wu)
    ye = torch.einsum("ebcf,efd->ebcd", h, wd)
    if tp is not None:
        ye = reduce_from_tp(ye, tp.group)

    # Combine: weighted un-dispatch back to [B, T, D]
    out = torch.einsum("btkec,ebcd->btd", combine.to(dt), ye)
    if ep > 1:
        out = reduce_from_tp(out, group)
    return out, aux


def _expert(w, e: int):
    """Expert ``e`` of a stacked [E, ...] table, raw or quantized."""
    return {k: _expert(v, e) for k, v in w.items()} if isinstance(w, dict) else w[e]


def moe_mlp_reference(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Drop-free top-k mixture: every token reaches its top-k experts (no
    capacity truncation).  The serving semantics (decode and the engines
    route through it) and the yardstick of what the capacity path drops.

    Where the reference scans over the stacked expert tables, a Python loop
    over experts accumulates into one f32 buffer, so no [E, B, T, F]
    tensor ever exists: peak memory is one [B, T, F] expert activation.
    Raw tables stream at the compute dtype with f32 activations; quantized
    ones go through :func:`~.quant.qdot`, one expert's slice at a time."""
    m = cfg.moe
    x32 = x.float()
    probs = torch.softmax(x32 @ p["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    w = (F.one_hot(idx, m.n_experts).float() * gates[..., None]).sum(2)  # [B,T,E]

    def wdot(x_, wt):
        if is_quantized(wt):
            return qdot(x_, wt)
        return x_ @ wt.to(cfg.compute_dtype).float()

    out = torch.zeros_like(x32)
    for e in range(m.n_experts):
        wg, wu, wd = (_expert(p[n], e) for n in ("w_gate", "w_up", "w_down"))
        h = F.silu(wdot(x32, wg)) * wdot(x32, wu)
        out.add_(w[..., e:e + 1] * wdot(h, wd))
    return out.to(x.dtype)
