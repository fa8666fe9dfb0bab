"""Training step for the flagship LM — the counterpart of
``tputopo/workloads/train.py``, on one device and sharded DP x TP.

:func:`train_step` is forward, next-token cross-entropy, grads and one
AdamW update, with optional gradient accumulation over microbatches.  The
optimizer is optax's ``adamw`` written out (:func:`make_optimizer`), and its
state mirrors optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``), so a
JAX ``TrainState`` converts leaf for leaf (:mod:`tputopo_torch.convert`).

Where the reference returns a new state, :func:`train_step` updates the
parameters and moments in place and returns the same tensors in a new
``TrainState``: at Llama-3-8B width a second copy of them would not fit on
one card.  The reference's sharded step donates its state buffers for the
same reason.

The sharded step (:func:`make_sharded_train_step`) runs on every rank of a
:class:`~.sharding.MeshPlan` over that rank's shards (:func:`make_sharded_state`)
and its dp block of the batch (:func:`~.sharding.local_batch`): local loss
and grads, with the model's tensor-parallel collectives when tp > 1 and a
vocab-parallel cross-entropy (:func:`vocab_parallel_nll`), then the grads'
sum over dp divided by dp, then AdamW on the local shards.  AdamW is
elementwise and clips nothing, so the update is the unsharded one.  The
pipelined and MoE steps come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tputopo_torch import sharding as shardlib
from tputopo_torch.model import (ModelConfig, _check_supported, all_reduce_f32,
                                 forward_with_aux, init_params, lm_head,
                                 reduce_from_tp, resolve_device, tp_context, trunk)


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the two moments,
    trees shaped like the parameters."""

    count: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


@dataclass
class TrainState:
    params: dict
    opt_state: AdamState
    step: torch.Tensor  # int32 scalar


def _leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a nested dict, keys sorted at every level: the order
    of ``jax.tree.leaves``, so grads line up leaf for leaf."""
    return [x for k in sorted(tree)
            for x in (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _rebuild(tree: dict, leaves) -> dict:
    """``tree``'s structure with ``leaves`` (in :func:`_leaves` order)."""
    it = iter(leaves)

    def go(t):
        return {k: go(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return go(tree)


@dataclass(frozen=True)
class AdamW:
    """optax ``adamw(lr, b1=0.9, b2=0.95, weight_decay=wd)``: bias-corrected
    Adam (eps 1e-8 outside the square root) plus decoupled weight decay on
    every leaf, norms and embeddings included, scaled by -lr."""

    lr: float = 3e-4
    weight_decay: float = 0.1

    B1, B2, EPS = 0.9, 0.95, 1e-8

    def init(self, params: dict) -> AdamState:
        def zeros() -> dict:
            return _rebuild(params, [torch.zeros_like(p) for p in _leaves(params)])

        count = torch.zeros((), dtype=torch.int32, device=params["final_norm"].device)
        return AdamState(count=count, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update_(self, grads: list[torch.Tensor], state: AdamState,
                params: dict) -> None:
        """Apply one step to ``params`` and ``state``, in place."""
        state.count += 1
        count = state.count.float()
        bc1 = 1 - self.B1 ** count
        bc2 = 1 - self.B2 ** count
        for p, g, mu, nu in zip(_leaves(params), grads, _leaves(state.mu),
                                _leaves(state.nu)):
            mu.mul_(self.B1).add_(g, alpha=1 - self.B1)
            nu.mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.EPS))
            p.sub_(u.add_(p, alpha=self.weight_decay).mul_(self.lr))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def make_train_state(config: ModelConfig, seed: int = 0, lr: float = 3e-4, *,
                     device=None) -> TrainState:
    """Fresh parameters from ``seed`` and zeroed AdamW moments, on
    ``device`` (``cuda`` by default, see :func:`~.model.resolve_device`)."""
    dev = resolve_device(device)
    params = init_params(config, seed, device=dev)
    return TrainState(params=params, opt_state=make_optimizer(lr).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids (last position
    dropped), from an f32 ``log_softmax``, plus the auxiliary loss.  Under
    an active plan with tp > 1, ``params`` are this rank's shards and the
    loss is :func:`vocab_parallel_nll`'s, the same on every tp rank."""
    tp = tp_context(config)
    if tp is not None:
        _check_supported(config)
        x, aux = trunk(params, tokens, config, tp)
        logits = lm_head(params, x, config, tp)  # [B, S, V / tp] f32
        targets = torch.as_tensor(tokens, device=logits.device)[:, 1:]
        return vocab_parallel_nll(logits[:, :-1], targets, tp).mean() + aux
    logits, aux = forward_with_aux(params, tokens, config)  # [B, S, V] f32
    targets = torch.as_tensor(tokens, device=logits.device)[:, 1:]
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + aux


def loss_and_grads(params: dict, tokens: torch.Tensor,
                   config: ModelConfig) -> tuple[torch.Tensor, list]:
    """``jax.value_and_grad(loss_fn)``: the loss and one grad per leaf of
    ``params`` (in :func:`_leaves` order), leaving ``params`` untouched."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    loss = loss_fn(_rebuild(params, leaves), tokens, config)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def accumulated_loss_and_grads(params: dict, tokens: torch.Tensor, config: ModelConfig,
                               accum_steps: int = 1) -> tuple[torch.Tensor, list]:
    """:func:`loss_and_grads` of the batch, or with ``accum_steps > 1`` the
    mean over that many equal microbatches, run one after another: their
    grads are summed, so activation memory drops to one microbatch's worth
    while the result is the full-batch gradient (exactly, for the dense
    model: cross-entropy means over equal chunks average to the full
    mean)."""
    if accum_steps <= 1:
        return loss_and_grads(params, tokens, config)
    B = tokens.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
    loss, grads = 0.0, None
    for mb in tokens.reshape(accum_steps, B // accum_steps, tokens.shape[1]):
        l, g = loss_and_grads(params, mb, config)
        loss = loss + l
        grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
    return loss / accum_steps, [g.div_(accum_steps) for g in grads]


def train_step(state: TrainState, tokens: torch.Tensor, config: ModelConfig,
               lr: float = 3e-4, accum_steps: int = 1) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step, in place; returns (state, loss).  ``accum_steps
    > 1`` accumulates the grads of that many microbatches and applies ONE
    update (:func:`accumulated_loss_and_grads`)."""
    loss, grads = accumulated_loss_and_grads(state.params, tokens, config, accum_steps)
    make_optimizer(lr).update_(grads, state.opt_state, state.params)
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=state.step + 1), loss


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       tp) -> torch.Tensor:
    """Per-token cross-entropy from this rank's block of the vocab
    (``logits`` [..., V / tp] f32, block ``tp.rank``), never gathering the
    whole logits: the all-reduce of the row max, of the sum of exps, and
    of the target's logit from the rank that holds it."""
    vl = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    sumexp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1), tp.group)
    local = targets - tp.rank * vl
    mine = (local >= 0) & (local < vl)
    picked = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    target_logit = reduce_from_tp(torch.where(mine, picked, 0.0), tp.group)
    return torch.log(sumexp) + m - target_logit


# ---- sharded ----------------------------------------------------------------

def opt_shardings(tree_shard, plan: shardlib.MeshPlan) -> AdamState:
    """Optimizer-state layout for a trainable tree laid out by
    ``tree_shard``: the AdamW moments mirror it, the count is replicated."""
    return AdamState(count=plan.replicated(), mu=tree_shard, nu=tree_shard)


def state_shardings(plan: shardlib.MeshPlan, config: ModelConfig,
                    lr: float = 3e-4) -> TrainState:
    """The layout of the whole TrainState, as axis names per dimension:
    params per :func:`~.sharding.param_specs`, the moments mirroring the
    params they track, the scalars replicated."""
    pspecs = shardlib.param_specs(plan, config)
    return TrainState(params=pspecs, opt_state=opt_shardings(pspecs, plan),
                      step=plan.replicated())


def make_sharded_state(plan: shardlib.MeshPlan, config: ModelConfig, seed: int = 0,
                       lr: float = 3e-4) -> TrainState:
    """This rank's shards of ``make_train_state(config, seed)`` on the plan's
    device, equal to the slices of that tree bit for bit: :func:`~.model.init_params`
    cuts each leaf to its block as it is drawn, so the whole tree is never
    resident."""
    pspecs = shardlib.param_specs(plan, config)

    def cut(path, leaf):
        spec = pspecs
        for k in path:
            spec = spec[k]
        return shardlib.shard_leaf(leaf, spec, plan)

    params = init_params(config, seed, device=plan.device, cut=cut)
    return TrainState(params=params, opt_state=make_optimizer(lr).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=plan.device))


def sharded_loss_and_grads(plan: shardlib.MeshPlan, params: dict,
                           tokens: torch.Tensor, config: ModelConfig,
                           accum_steps: int = 1) -> tuple[torch.Tensor, list]:
    """This rank's part of one step before the update: the global loss and
    the global grads' local shards (in :func:`_leaves` order), from this
    rank's block of the batch ``tokens`` (:func:`~.sharding.local_batch`).
    At tp = 1 the local loss is :func:`loss_fn`'s unsharded path exactly."""
    plan.check_supported()
    with shardlib.activate(plan):
        loss, grads = accumulated_loss_and_grads(params, tokens, config, accum_steps)
    if shardlib.kv_replicated(plan, config) and plan.size("tp") > 1:
        # each tp rank holds the grad of wk/wv from its own q heads only
        names = _leaf_names(params)
        for i, name in enumerate(names):
            if name in ("layers.wk", "layers.wv"):
                dist.all_reduce(grads[i], group=plan.group("tp"))
    dp, group = plan.size("dp"), plan.group("dp")
    for g in grads:
        dist.all_reduce(g, group=group)
        g.div_(dp)
    loss = all_reduce_f32(loss.reshape(1), group)[0] / dp
    return loss, grads


def _leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Dotted leaf names in :func:`_leaves` order."""
    return [n for k in sorted(tree) for n in (
        _leaf_names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
        else [prefix + k])]


def make_sharded_train_step(plan: shardlib.MeshPlan, config: ModelConfig,
                            lr: float = 3e-4, n_micro: int | None = None,
                            accum_steps: int = 1):
    """The step over ``plan``: ``step(state, tokens) -> (state, loss)``
    with ``state`` this rank's shards and ``tokens`` this rank's block of
    the global batch.  It updates the shards in place, as
    :func:`train_step` does, and returns the global loss.  ``n_micro``
    (GPipe microbatches) belongs to the pipelined step of a later slice."""
    plan.check_supported()
    if n_micro is not None:
        raise NotImplementedError("n_micro schedules the GPipe pipeline, which "
                                  "comes with the GPipe slice (pipeline.py)")
    opt = make_optimizer(lr)

    def step(state: TrainState, tokens: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        loss, grads = sharded_loss_and_grads(plan, state.params, tokens, config,
                                             accum_steps)
        opt.update_(grads, state.opt_state, state.params)
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step + 1), loss

    return step
