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

Serving computes the drop-free mixture instead (every token reaches its
top-k experts).  On CUDA with raw expert tables and a bfloat16 compute
dtype it takes :func:`moe_mlp_routed`: the (token, expert) pairs sorted
by expert on the device, their rows gathered once, the three expert
products as grouped bf16 GEMMs over the per-expert segments
(``torch._grouped_mm``), the rows weighted by their gates and summed back
per token; its shapes are fixed by the token count, so it replays inside
the serving engine's CUDA graphs.  Quantized tables, other compute dtypes
and the CPU keep :func:`moe_mlp_reference`, a loop over the experts.  A
tracer's counts of the routed layer (:class:`ExpertCounts`) are added to on
the device, inside the captured programs, while :func:`counting` is on.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tputopo_torch import _graphs, _kernels
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
    # DeepSeek-V3's layout (serving only; the training path refuses it):
    # leading layers with the dense FFN (width d_ff), each expert's width
    # (None: d_ff), shared experts of that width every token reaches, and
    # the experts [lo, hi) of the n_experts that this chip holds (None:
    # all), as one rank of expert parallelism holds its share.
    first_dense: int = 0
    d_expert: int | None = None
    n_shared: int = 0
    held: tuple[int, int] | None = None
    # Routing: "softmax" (top k of a softmax, gates renormalised over the
    # k) or "sigmoid" (DeepSeek-V3's: sigmoid scores, a bias that takes part
    # in the choice only, the best ``topk_group`` of ``n_group`` groups by
    # the sum of each group's top 2, the top k within them, the gates the
    # scores renormalised over the k and scaled by ``routed_scale``).
    scoring: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0

    SCORINGS = ("softmax", "sigmoid")

    def __post_init__(self):
        if self.scoring not in self.SCORINGS:
            raise ValueError(f"unknown scoring {self.scoring!r} (want one of "
                             f"{self.SCORINGS})")
        if self.n_experts % self.n_group or not 1 <= self.topk_group <= self.n_group:
            raise ValueError(f"{self.n_experts} experts in {self.n_group} groups, "
                             f"top {self.topk_group}: groups must divide the experts")
        lo, hi = self.held_range
        if not 0 <= lo < hi <= self.n_experts:
            raise ValueError(f"held experts {self.held} outside [0, {self.n_experts})")

    @property
    def held_range(self) -> tuple[int, int]:
        return self.held if self.held is not None else (0, self.n_experts)

    @property
    def n_held(self) -> int:
        lo, hi = self.held_range
        return hi - lo

    def width(self, cfg) -> int:
        """Each expert's (and each shared expert's) FFN width."""
        return self.d_expert or cfg.d_ff

    def capacity(self, group_tokens: int) -> int:
        raw = group_tokens * self.top_k * self.capacity_factor / self.n_experts
        cap = int(-(-raw // 8) * 8)  # ceil to multiple of 8
        return max(8, min(cap, group_tokens))


def init_moe_params(cfg, seed: int = 0, *, device=None, dense=None) -> dict:
    """Per-layer MoE tensors stacked on a leading axis over the expert layers
    (all but the ``first_dense``), expert axis second: router [L, D, E],
    the held experts' FFN [L, E_held, D, F] / [L, E_held, F, D], f32; a
    sigmoid router's bias [L, E] (zeros), and the shared experts' SwiGLU
    ``shared_gate`` / ``shared_up`` [L, D, n_shared F], ``shared_down``.

    ``dense(name, shape, fan_in)`` draws one leaf; by default N(0, 1/fan_in)
    from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (:func:`~.model.init_params` passes its own, so a model draws from one
    stream)."""
    m = cfg.moe
    L, D, Fd, E = cfg.n_layers - m.first_dense, cfg.d_model, m.width(cfg), m.n_experts
    Eh = m.n_held
    if dense is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def dense(name, shape, fan_in):
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return w.mul_(1.0 / math.sqrt(fan_in))

    out = {  # the dict order is the draw order
        "router": dense("router", (L, D, E), D),
        "w_gate": dense("w_gate", (L, Eh, D, Fd), D),
        "w_up": dense("w_up", (L, Eh, D, Fd), D),
        "w_down": dense("w_down", (L, Eh, Fd, D), Fd),
    }
    if m.scoring == "sigmoid":
        out["bias"] = torch.zeros((L, E), dtype=torch.float32,
                                  device=out["router"].device)
    if m.n_shared:
        Fs = m.n_shared * Fd
        out["shared_gate"] = dense("shared_gate", (L, D, Fs), D)
        out["shared_up"] = dense("shared_up", (L, D, Fs), D)
        out["shared_down"] = dense("shared_down", (L, Fs, D), Fs)
    return out


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


EXPERT_TABLES = ("w_gate", "w_up", "w_down")


def _expert(w, e: int):
    """Expert ``e`` of a stacked [E, ...] table, raw or quantized."""
    return {k: _expert(v, e) for k, v in w.items()} if isinstance(w, dict) else w[e]


def _top_k_gates(x32: torch.Tensor, router: torch.Tensor, m: MoEConfig):
    """The drop-free routing of x32 [..., D] (float32): a softmax over the
    router's logits, the top k, and their gates renormalised over the k ->
    (gates [..., k] float32, expert ids [..., k])."""
    probs = torch.softmax(x32 @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _sigmoid_gates(x32: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
                   m: MoEConfig):
    """DeepSeek-V3's routing of x32 [..., D] (float32): sigmoid scores; the
    bias added for the choice only; each of ``n_group`` groups scored by the
    sum of its two best biased scores, the best ``topk_group`` groups kept
    and the top k chosen inside them; the gates are the chosen experts'
    unbiased scores renormalised over the k and scaled by ``routed_scale``
    -> (gates [..., k] float32, expert ids [..., k])."""
    scores = torch.sigmoid(x32 @ router.float())
    choice = scores + bias.float()
    if m.n_group > 1:
        grouped = choice.unflatten(-1, (m.n_group, -1))
        best = grouped.topk(2, dim=-1).values.sum(-1)                     # [..., G]
        kept = best.topk(m.topk_group, dim=-1).indices
        allowed = torch.zeros_like(best, dtype=torch.bool).scatter_(-1, kept, True)
        choice = grouped.masked_fill(~allowed[..., None], float("-inf")).flatten(-2)
    idx = choice.topk(m.top_k, dim=-1).indices
    gates = scores.gather(-1, idx)
    return gates / (gates.sum(-1, keepdim=True) + 1e-20) * m.routed_scale, idx


def route(x32: torch.Tensor, p: dict, m: MoEConfig):
    """The serving paths' routing by the config's rule -> (gates [..., k]
    float32, expert ids [..., k] over all ``n_experts``)."""
    if m.scoring == "sigmoid":
        return _sigmoid_gates(x32, p["router"], p["bias"], m)
    return _top_k_gates(x32, p["router"], m)


def _shared_expert(x: torch.Tensor, p: dict, dot=qdot) -> torch.Tensor:
    """The shared experts' SwiGLU on every token, its products by ``dot``."""
    return dot(F.silu(dot(x, p["shared_gate"])) * dot(x, p["shared_up"]),
               p["shared_down"])


def moe_mlp_reference(x: torch.Tensor, p: dict, cfg, *, picks: bool = False):
    """Drop-free top-k mixture: every token reaches its top-k experts (no
    capacity truncation).  The yardstick of what the capacity path drops,
    and what serving computes where :func:`moe_mlp_routed` does not take
    the layer (:func:`routed_takes`): quantized tables, a compute dtype
    other than bfloat16, the CPU.

    Where the reference scans over the stacked expert tables, a Python loop
    over experts accumulates into one f32 buffer, so no [E, B, T, F]
    tensor ever exists: peak memory is one [B, T, F] expert activation.
    Every held expert computes on every token, its gate zero where it was
    not chosen; the pairs routed to experts not held here add nothing.
    Raw tables stream at the compute dtype with f32 activations;
    quantized ones go through :func:`~.quant.qdot`, one expert's slice at a
    time.  Shared experts add their SwiGLU for every token.  With
    ``picks``, (output, the top-k expert ids [B, T, k])."""
    m = cfg.moe
    x32 = x.float()
    gates, idx = route(x32, p, m)
    w = (F.one_hot(idx, m.n_experts).float() * gates[..., None]).sum(2)  # [B,T,E]

    def wdot(x_, wt):
        if is_quantized(wt):
            return qdot(x_, wt)
        return x_ @ wt.to(cfg.compute_dtype).float()

    out = torch.zeros_like(x32)
    lo, hi = m.held_range
    for e in range(lo, hi):
        wg, wu, wd = (_expert(p[n], e - lo) for n in EXPERT_TABLES)
        h = F.silu(wdot(x32, wg)) * wdot(x32, wu)
        out.add_(w[..., e:e + 1] * wdot(h, wd))
    if m.n_shared:
        out.add_(_shared_expert(x32, p, wdot))
    return (out.to(x.dtype), idx) if picks else out.to(x.dtype)


# ---- serving: the routed, drop-free expert layer -----------------------------

def routed_takes(x: torch.Tensor, p: dict, cfg) -> bool:
    """Whether serving computes this layer by :func:`moe_mlp_routed`: on
    CUDA, with raw (unquantized) expert tables and a bfloat16 compute dtype,
    the one ``torch._grouped_mm`` computes in."""
    return (x.device.type == "cuda" and cfg.compute_dtype == torch.bfloat16
            and not any(is_quantized(p[n]) for n in EXPERT_TABLES))


def grouped_mm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """a [P, K] with its rows grouped, b [G, K, N], ``ends`` [G] int32 the
    cumulative end row of each group (the last is P) -> [P, N]: rows
    ``ends[g-1]:ends[g]`` of ``a`` times ``b[g]``; an empty group is
    skipped.  On CUDA one ``torch._grouped_mm`` (bfloat16 operands, float32
    accumulation, bfloat16 out) reading the ends on the device, counted in
    ``_kernels.GROUPED_MM``; elsewhere a loop over the groups, which reads
    the ends back."""
    if a.device.type != "cuda":
        out = a.new_zeros(a.shape[0], b.shape[-1])
        lo = 0
        for g, hi in enumerate(ends.tolist()):
            if hi > lo:
                out[lo:hi] = a[lo:hi] @ b[g]
            lo = hi
        return out
    out = torch._grouped_mm(a, b, offs=ends)
    if _graphs.capturing(a.device):
        _kernels.GROUPED_MM.captured += 1
    else:
        _kernels.GROUPED_MM.launches += 1
    return out


class ExpertCounts:
    """A tracer's counts of the routed layer, held on the device as int64
    running sums and added to inside the captured programs (no readback):
    ``calls``; ``pairs``, the routed (token, expert) pairs; ``experts_hit``,
    the experts with at least one pair, summed over calls; ``max_load``, the
    busiest expert's pairs, summed over calls (``pairs`` and the two after
    it count the experts held here only, the pairs the layer computes);
    ``pairs_all``, the pairs routed over all the router's experts; and on
    CUDA ``device_ns``, the layer's device time from the GPU's global timer
    at its start and end (``csrc/obs/device_clock.cu``).  :meth:`snapshot`
    reads them back."""

    NAMES = ("calls", "pairs", "experts_hit", "max_load", "pairs_all", "device_ns")

    def __init__(self, device) -> None:
        self.values = torch.zeros(len(self.NAMES), dtype=torch.int64, device=device)

    def add(self, per_expert: torch.Tensor, pairs_all: int) -> None:
        """One call whose pairs per held expert are ``per_expert`` [E] int64,
        of ``pairs_all`` routed."""
        one = torch.ones((), dtype=torch.int64, device=per_expert.device)
        self.values[:5] += torch.stack((one, per_expert.sum(), (per_expert > 0).sum(),
                                        per_expert.max(), one * pairs_all))

    def clock(self, sign: int) -> None:
        """Add ``sign`` x the GPU's global timer to ``device_ns`` (-1 where
        the layer starts, +1 where it ends); nothing off CUDA."""
        if self.values.device.type == "cuda":
            from tputopo_torch import attention

            attention._call(_kernels.DEVICE_CLOCK,
                            (self.values[5:].data_ptr(), sign, 0.0), self.values.device,
                            "device clock")

    def snapshot(self) -> dict:
        return dict(zip(self.NAMES, self.values.tolist()))


# The counts the routed layer adds to (:func:`counting`); None: it counts
# nothing and adds no operation.
_COUNTS: ExpertCounts | None = None
_graphs.AMBIENT.append(lambda: None if _COUNTS is None else _COUNTS.values)


@contextlib.contextmanager
def counting(counts: ExpertCounts | None):
    """Within the block, the routed layer adds to ``counts`` (None: to
    nothing).  A program captured inside the block records the additions,
    and each replay makes them again; the counts' storage is part of every
    capture's key (:data:`~._graphs.AMBIENT`)."""
    global _COUNTS
    before, _COUNTS = _COUNTS, counts
    try:
        yield
    finally:
        _COUNTS = before


def moe_mlp_routed(x: torch.Tensor, p: dict, cfg, *, picks: bool = False):
    """The drop-free top-k mixture of :func:`moe_mlp_reference`, computed
    on the routed pairs only: x [B, T, D] -> [B, T, D].

    The router, its scores, the top k and the gates are the same operations
    (:func:`route`), in float32.  The B*T*k (token, expert) pairs are sorted
    by expert on the device (a stable sort, so each expert's pairs keep
    their token order); each expert's segment ends at the running sum of
    its pair count, taken by a scatter-add.  The pairs' rows, gathered into
    one [B*T*k, D] buffer at the compute dtype, go through the three expert
    products as grouped GEMMs over the segments (:func:`grouped_mm`), each
    table cast from its float32 master at the call as ``qdot`` casts a
    dense weight.  Each pair's output row, weighted by its gate in float32,
    is put back at its (token, slot) place and the k slots of a token are
    summed in slot order, so the result does not depend on the order in
    which the device adds.  No step reads a value back to the host and
    every shape is fixed by B*T, so the layer replays inside a CUDA graph.

    Where the config holds a share of the experts (``held``), the router
    still chooses over all of them; the pairs of experts not held here sort
    after the held experts' segments, which the grouped GEMMs stop at, and
    their rows add zero.  Shared experts add their SwiGLU for every token.

    It departs from :func:`moe_mlp_reference` as the dense serving FFN
    departs from a float32 one: the expert activations (the gathered rows,
    the products, the SiLU gate) are bfloat16 where the loop keeps them in
    float32 against bfloat16 weights.  With ``picks``, (output, the top-k
    expert ids [B, T, k])."""
    m = cfg.moe
    B, T, D = x.shape
    k = m.top_k
    counts = _COUNTS
    if counts is not None:
        counts.clock(-1)
    x2 = x.reshape(B * T, D)
    gates, idx = route(x2.float(), p, m)                              # [N, k]
    flat = idx.reshape(-1)                                           # pair -> expert
    held = None
    if m.held is not None:  # experts outside [lo, hi) sort last, as one more key
        lo, hi = m.held
        held = (flat >= lo) & (flat < hi)
        flat = torch.where(held, flat - lo, hi - lo)
    E = m.n_held
    order = torch.sort(flat, stable=True).indices                    # pairs by expert
    per_expert = torch.zeros(E + (held is not None), dtype=torch.int64,
                             device=x.device).scatter_add_(0, flat, torch.ones_like(flat))[:E]
    ends = per_expert.cumsum(0).to(torch.int32)
    dt = cfg.compute_dtype
    rows = x2.to(dt).index_select(0, order // k)                     # [N*k, D]
    h = F.silu(grouped_mm(rows, p["w_gate"].to(dt), ends))
    h = h * grouped_mm(rows, p["w_up"].to(dt), ends)
    y = grouped_mm(h, p["w_down"].to(dt), ends).float()              # [N*k, D]
    y = y * gates.reshape(-1).index_select(0, order)[:, None]
    if held is not None:  # rows past the held segments hold no product
        y = torch.where(held.index_select(0, order)[:, None], y, 0.0)
    y = torch.empty_like(y).index_copy_(0, order, y)                 # back in pair order
    out = y.reshape(B * T, k, D).sum(1)
    if m.n_shared:
        out = out + _shared_expert(x2.to(dt), p).float()
    if counts is not None:
        counts.add(per_expert, B * T * k)
        counts.clock(1)
    out = out.reshape(B, T, D).to(x.dtype)
    return (out, idx.reshape(B, T, k)) if picks else out
