"""Pipeline parallelism over the ``pp`` mesh axis — GPipe, the counterpart of
``tputopo/workloads/pipeline.py``.

The layer stack is cut into ``pp`` contiguous stages (:func:`~.sharding.param_specs`
splits the stacked layer axis over ``pp``, so each rank holds its own
stage's layers and nothing else), microbatches stream through the stages,
and each stage-to-stage hand-off is one point-to-point message over the
``pp`` group (:func:`~.sharding.exchange`).

Where the reference writes the schedule as a scan over ``M + pp - 1``
ticks and lets reverse-mode autodiff of that scan be the backward
pipeline, the port drives both schedules by hand in one
``torch.autograd.Function`` (:class:`_Pipeline`), so every rank posts the
matching send and receive of every hand-off, forward and backward, in the
same order:

- forward: for each microbatch ``m`` in order, stage 0 takes microbatch
  ``m`` of the embedded batch, a later stage receives it from its
  predecessor; the stage runs its layers, and hands the result on (the
  last stage banks it).  A stage computes only its ``M`` real
  microbatches: the bubble ticks, on which the reference computes a value
  it then discards, cost nothing here.  aux sums over the real
  microbatches, as the reference's masked sum does.
- backward: for each microbatch in reverse, the last stage takes the
  gradient of its banked output, an earlier stage receives it from its
  successor; the stage recomputes its layers from the saved input (GPipe's
  rematerialisation, whatever ``remat`` says: the stage input is all a
  microbatch keeps between the two passes), takes the gradients of its
  inputs and parameters, and sends the input's gradient back.

The banked outputs reach every ``pp`` rank (the reference's
``all_gather(...)[pp - 1]``) by a broadcast from the last stage, and aux is
summed over ``pp`` and divided by ``M``; the head runs after, on every
rank.  The loss is then the same on every ``pp`` rank, as it is the same on
every ``tp`` rank: the broadcast's backward keeps the gradient on the last
stage, and the embedding's output enters through :func:`~.model.copy_to_tp`
over ``pp`` (identity forward, all-reduce of the gradient backward), so the
replicated leaves' grads come out whole on every stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tputopo_torch.model import (ModelConfig, _layer, copy_to_tp,
                                 embed_tokens, reduce_from_tp, rope_for_rank,
                                 transformer_block)
from tputopo_torch.sharding import MeshPlan, activate, broadcast, exchange


def _stage_body(layers_local: dict, x: torch.Tensor, config: ModelConfig, cos, sin,
                tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run this stage's layers (leading axis L/pp) on one microbatch."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(layers_local["attn_norm"].shape[0]):
        x, a = transformer_block(x, _layer(layers_local, i), config, cos, sin, tp)
        aux = aux + a
    return x, aux


@dataclass(frozen=True)
class _Stage:
    """What the pipeline's autograd function needs besides tensors."""

    config: ModelConfig
    plan: MeshPlan
    layers: dict  # the stage's layer tree: its structure for _rebuild
    cos: torch.Tensor
    sin: torch.Tensor
    tp: object
    n_micro: int


class _Pipeline(torch.autograd.Function):
    """GPipe over ``pp``: forward (microbatches ``xm`` [M, b, S, D], the
    stage's layer leaves in :func:`~.train._leaves` order) -> (the banked
    outputs [M, b, S, D], valid on the last stage and zero elsewhere; this
    stage's aux over its real microbatches)."""

    @staticmethod
    def forward(ctx, stage: _Stage, xm, *leaves):
        from tputopo_torch.train import _rebuild

        plan, M = stage.plan, stage.n_micro
        i, last = plan.rank("pp"), plan.size("pp") - 1
        layers = _rebuild(stage.layers, leaves)
        outs = torch.zeros_like(xm)
        aux = torch.zeros((), dtype=torch.float32, device=xm.device)
        inputs = []
        for m in range(M):
            if i == 0:
                inp = xm[m]
            else:
                inp = torch.empty_like(xm[m])
                exchange(plan, "pp", [], [(inp, i - 1)])
            inputs.append(inp)
            out, a = _stage_body(layers, inp, stage.config, stage.cos, stage.sin,
                                 stage.tp)
            aux += a
            if i < last:
                exchange(plan, "pp", [(out, i + 1)], [])
            else:
                outs[m] = out
        ctx.stage, ctx.inputs = stage, inputs
        ctx.save_for_backward(*leaves)
        return outs, aux

    @staticmethod
    def backward(ctx, g_outs, g_aux):
        from tputopo_torch.train import _rebuild

        stage, leaves = ctx.stage, ctx.saved_tensors
        plan, M = stage.plan, stage.n_micro
        i, last = plan.rank("pp"), plan.size("pp") - 1
        needs = ctx.needs_input_grad[2:]
        grads = [torch.zeros_like(t) if need else None for t, need in zip(leaves, needs)]
        g_xm = torch.zeros_like(g_outs) if ctx.needs_input_grad[1] else None
        for m in reversed(range(M)):
            if i == last:
                g_out = g_outs[m]
            else:
                g_out = torch.empty_like(ctx.inputs[m])
                exchange(plan, "pp", [], [(g_out, i + 1)])
            with torch.enable_grad():
                inp = ctx.inputs[m].detach().requires_grad_(i > 0 or g_xm is not None)
                ls = [t.detach().requires_grad_(need) for t, need in zip(leaves, needs)]
                out, a = _stage_body(_rebuild(stage.layers, ls), inp, stage.config,
                                     stage.cos, stage.sin, stage.tp)
                outputs, cotangents = [out], [g_out]
                if a.requires_grad:
                    outputs.append(a)
                    cotangents.append(g_aux)
                wrt = [t for t in (inp, *ls) if t.requires_grad]
                got = iter(torch.autograd.grad(outputs, wrt, cotangents,
                                               allow_unused=True) if wrt else ())
            g_inp = next(got) if inp.requires_grad else None
            for j, t in enumerate(ls):
                if t.requires_grad:
                    g = next(got)
                    if g is not None:
                        grads[j] += g
            if i > 0:
                exchange(plan, "pp", [(g_inp, i - 1)], [])
            elif g_xm is not None and g_inp is not None:
                g_xm[m] = g_inp
        return (None, g_xm, *grads)


class _FromLastStage(torch.autograd.Function):
    """The last stage's tensor on every ``pp`` rank forward (a broadcast, in
    f32); the gradient kept on the last stage backward."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.last = plan.rank("pp") == plan.size("pp") - 1
        y = x.to(torch.float32, copy=True)
        broadcast(y, plan.peer("pp", plan.size("pp") - 1), plan.group("pp"))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipelined_trunk(params: dict, tokens: torch.Tensor, config: ModelConfig,
                    plan: MeshPlan, n_micro: int | None = None,
                    tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~.model.trunk` with the layer stack pipelined over ``pp``:
    this rank's tokens [B, S] -> (the last layer's output [B, S, D] on
    every pp rank, aux loss scalar).  ``params`` are this rank's shards
    (its stage's layers); ``n_micro`` microbatches (default pp) must divide
    B, and pp the layers."""
    c = config
    pp = plan.size("pp")
    M = n_micro or pp
    B, S = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    if c.n_layers % pp:
        raise ValueError(f"{c.n_layers} layers not divisible into {pp} stages")
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens, device=device)
    cos, sin = rope_for_rank(c, S, device)
    x = copy_to_tp(embed_tokens(params, tokens, c), plan.group("pp"))
    D = x.shape[-1]
    from tputopo_torch.train import _leaves

    stage = _Stage(c, plan, params["layers"], cos, sin, tp, M)
    outs, aux = _Pipeline.apply(stage, x.reshape(M, B // M, S, D),
                                *_leaves(params["layers"]))
    x = _FromLastStage.apply(outs, plan).reshape(B, S, D)
    # aux over the M microbatch routing groups, as unpipelined training
    return x, reduce_from_tp(aux, plan.group("pp")) / M


def pipelined_forward_with_aux(params: dict, tokens: torch.Tensor,
                               config: ModelConfig, plan: MeshPlan,
                               n_micro: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`~.model.forward_with_aux` with the layer stack pipelined over
    ``pp`` (the plain forward when pp is 1), under ``plan`` on this rank's
    shards and block of the batch."""
    from tputopo_torch.model import forward_with_aux

    with activate(plan):
        return forward_with_aux(params, tokens, config, n_micro=n_micro)
