"""Training step for the flagship LM — the counterpart of
``tputopo/workloads/train.py``, on one device and sharded over a mesh plan.

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
elementwise and clips nothing, so the update is the unsharded one.

The other axes keep that shape.  Under ``ep`` (MoE experts) and ``pp``
(the GPipe pipeline, ``n_micro`` microbatches) the loss is the same on
every rank, as under ``tp``.  Under ``sp`` each rank holds a chunk of the
sequence and its loss is its chunk's share of the global next-token mean;
the step sums loss and grads over ``sp`` before the mean over ``dp``.

The step :func:`make_sharded_train_step` returns is the reference's jitted
step, whose state is donated: one compiled program (:mod:`._graphs`), a
CUDA-graph capture of the local loss and grads, the collectives and the
AdamW update, replayed on every call after the first, whose warm-up did
that call's work on the state in place.  It replays on CUDA when the
plan's groups are NCCL's; under gloo and on the CPU it runs eagerly.  The
step counter advances in place, so the bound state keeps its storage and
one capture serves every call.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tputopo_torch import _graphs
from tputopo_torch import sharding as shardlib
from tputopo_torch.model import (ModelConfig, _check_supported, all_reduce_f32,
                                 check_token_ids, init_params, lm_head, reduce_from_tp,
                                 resolve_device, tp_context, trunk)


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
    every leaf, norms and embeddings included, scaled by -lr.  It takes
    any tree of tensors: the model's, or a LoRA adapter's."""

    lr: float = 3e-4
    weight_decay: float = 0.1

    B1, B2, EPS = 0.9, 0.95, 1e-8

    def init(self, params: dict) -> AdamState:
        leaves = _leaves(params)

        def zeros() -> dict:
            return _rebuild(params, [torch.zeros_like(p) for p in leaves])

        count = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
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
            if self.weight_decay:
                u.add_(p, alpha=self.weight_decay)
            p.sub_(u.mul_(self.lr))


@dataclass(frozen=True)
class Adam(AdamW):
    """optax ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 and no weight decay
    (the vision model's optimizer); the same state as :class:`AdamW`."""

    weight_decay: float = 0.0

    B2 = 0.999


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


def loss_fn(params: dict, tokens: torch.Tensor, config: ModelConfig,
            n_micro: int | None = None) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids (last position
    dropped), from an f32 ``log_softmax``, plus the auxiliary loss.  Under
    an active plan, ``params`` are this rank's shards and ``tokens`` its
    block of the batch: with tp > 1 the cross-entropy is
    :func:`vocab_parallel_nll`'s, the same on every tp rank; with sp > 1
    ``tokens`` is this rank's chunk of the sequence, whose last position
    targets the next chunk's first token, and the loss is the chunk's share
    of the mean over all ``B * (S - 1)`` positions plus ``aux / sp``, so
    that the sum over sp is the global loss.  ``n_micro`` sets the GPipe
    microbatches under pp > 1."""
    from tputopo_torch.sharding import active_plan

    _check_supported(config)
    tp = tp_context(config)
    x, aux = trunk(params, tokens, config, tp, n_micro)
    logits = lm_head(params, x, config, tp)  # [B, S, V] f32, V / tp under tp
    tokens = torch.as_tensor(tokens, device=logits.device)
    plan = active_plan()
    sp = plan.size("sp") if plan is not None else 1
    if sp == 1:
        logits, targets = logits[:, :-1], tokens[:, 1:]
    else:
        from tputopo_torch.sharding import all_gather

        r = plan.rank("sp")
        firsts = all_gather(tokens[:, 0], plan.group("sp"))
        targets = torch.cat([tokens[:, 1:], firsts[(r + 1) % sp][:, None]], dim=1)
        if r == sp - 1:  # the sequence's last position has no target
            logits, targets = logits[:, :-1], targets[:, :-1]
    if tp is not None:
        nll = vocab_parallel_nll(logits, targets, tp)
    else:
        nll = -F.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    if sp == 1:
        return nll.mean() + aux
    B, Sc = tokens.shape
    return nll.sum() / (B * (Sc * sp - 1)) + aux / sp


def loss_and_grads(params: dict, tokens: torch.Tensor, config: ModelConfig,
                   loss=loss_fn, tracer=None) -> tuple[torch.Tensor, list]:
    """``jax.value_and_grad(loss)``: the loss and one grad per leaf of
    ``params`` (in :func:`_leaves` order), leaving ``params`` untouched.
    ``loss(params, tokens, config)`` is :func:`loss_fn` unless another
    objective is given (the LoRA step differentiates in the adapter).
    With a ``tracer`` whose lap group is open (:meth:`~.obs.Tracer.lap_group`),
    the forward ends the lap ``train.forward`` and the grads the lap
    ``train.backward``."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    value = loss(_rebuild(params, leaves), tokens, config)
    if tracer is not None:
        tracer.lap("train.forward", leaves[0].device)
    grads = list(torch.autograd.grad(value, leaves))
    if tracer is not None:
        tracer.lap("train.backward", leaves[0].device)
    return value.detach(), grads


def accumulated_loss_and_grads(params: dict, tokens: torch.Tensor, config: ModelConfig,
                               accum_steps: int = 1, loss=loss_fn,
                               tracer=None) -> tuple[torch.Tensor, list]:
    """:func:`loss_and_grads` of the batch, or with ``accum_steps > 1`` the
    mean over that many equal microbatches, run one after another: their
    grads are summed, so activation memory drops to one microbatch's worth
    while the result is the full-batch gradient (exactly, for the dense
    model: cross-entropy means over equal chunks average to the full
    mean)."""
    if accum_steps <= 1:
        return loss_and_grads(params, tokens, config, loss, tracer)
    B = tokens.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} not divisible by accum_steps {accum_steps}")
    total, grads = 0.0, None
    for mb in tokens.reshape(accum_steps, B // accum_steps, tokens.shape[1]):
        l, g = loss_and_grads(params, mb, config, loss, tracer)
        total = total + l
        grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
    return total / accum_steps, [g.div_(accum_steps) for g in grads]


def train_step(state: TrainState, tokens: torch.Tensor, config: ModelConfig,
               lr: float = 3e-4, accum_steps: int = 1) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step, in place, the step counter included; returns
    (state, loss).  ``accum_steps > 1`` accumulates the grads of that many
    microbatches and applies ONE update (:func:`accumulated_loss_and_grads`)."""
    loss, grads = accumulated_loss_and_grads(state.params, tokens, config, accum_steps)
    make_optimizer(lr).update_(grads, state.opt_state, state.params)
    state.step.add_(1)
    return state, loss


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


def make_sharded_params(plan: shardlib.MeshPlan, config: ModelConfig,
                        seed: int = 0) -> dict:
    """This rank's shards of ``init_params(config, seed)`` on the plan's
    device, equal to the slices of that tree bit for bit: each leaf is cut
    to its block as it is drawn (:func:`~.model.init_params`' ``cut``), so
    the whole tree is never resident."""
    pspecs = shardlib.param_specs(plan, config)

    def cut(path, leaf):
        spec = pspecs
        for k in path:
            spec = spec[k]
        return shardlib.shard_leaf(leaf, spec, plan)

    return init_params(config, seed, device=plan.device, cut=cut)


def make_sharded_state(plan: shardlib.MeshPlan, config: ModelConfig, seed: int = 0,
                       lr: float = 3e-4) -> TrainState:
    """This rank's shards of ``make_train_state(config, seed)``
    (:func:`make_sharded_params`) with zeroed AdamW moments."""
    params = make_sharded_params(plan, config, seed)
    return TrainState(params=params, opt_state=make_optimizer(lr).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=plan.device))


def sharded_loss_and_grads(plan: shardlib.MeshPlan, params: dict,
                           tokens: torch.Tensor, config: ModelConfig,
                           accum_steps: int = 1, *, loss=loss_fn,
                           tp_partial=None, tracer=None) -> tuple[torch.Tensor, list]:
    """This rank's part of one step before the update: the global loss and
    the global grads' local shards (in :func:`_leaves` order), from this
    rank's block of the batch ``tokens`` (:func:`~.sharding.local_batch`).
    At tp = 1 the local loss is :func:`loss_fn`'s unsharded path exactly.

    ``tp_partial`` names the leaves (dotted, :func:`_leaf_names`) whose
    local grad is a partial sum over the tp ranks, summed here: by default
    ``wk``/``wv`` when they are kept whole (:func:`~.sharding.kv_replicated`),
    each tp rank holding their grad from its own q heads only.  Under sp
    the loss and every grad are summed over sp (no leaf is split over sp,
    and each rank's are its chunk's share).  A ``tracer`` is passed on to
    :func:`loss_and_grads`; the collectives here end one more lap
    ``train.backward``."""
    with shardlib.activate(plan):
        value, grads = accumulated_loss_and_grads(params, tokens, config,
                                                  accum_steps, loss, tracer)
    if tp_partial is None:
        tp_partial = (("layers.wk", "layers.wv")
                      if shardlib.kv_replicated(plan, config) else ())
    if plan.size("tp") > 1 and tp_partial:
        for name, g in zip(_leaf_names(params), grads):
            if name in tp_partial:
                dist.all_reduce(g, group=plan.group("tp"))
    if plan.size("sp") > 1:
        group = plan.group("sp")
        value = all_reduce_f32(value.reshape(1), group)[0]
        for g in grads:
            dist.all_reduce(g, group=group)
    value = dp_mean_(plan, value, grads)
    if tracer is not None:
        tracer.lap("train.backward", plan.device)
    return value, grads


def dp_mean_(plan: shardlib.MeshPlan, value: torch.Tensor, grads: list) -> torch.Tensor:
    """The mean over the plan's dp ranks of this rank's loss ``value`` and
    ``grads``: the grads summed over dp (f32 masters, so f32 grads) and
    divided by dp in place, the loss in f32.  For equal local batches this
    is the global batch's mean.  Returns the mean loss."""
    dp, group = plan.size("dp"), plan.group("dp")
    for g in grads:
        dist.all_reduce(g, group=group)
        g.div_(dp)
    return all_reduce_f32(value.reshape(1), group)[0] / dp


def _leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Dotted leaf names in :func:`_leaves` order."""
    return [n for k in sorted(tree) for n in (
        _leaf_names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
        else [prefix + k])]


def donated_step(programs: _graphs.Programs, name: str, body, state, *,
                 inputs: tuple, plan: shardlib.MeshPlan | None, device, static: tuple,
                 frozen=None) -> torch.Tensor:
    """``body(*inputs)``, a training step that updates ``state`` in place
    and returns its loss, as the donated program ``name`` of ``programs``
    (the reference's ``donate_argnums``, :mod:`._graphs`): keyed on
    ``static``, the input shapes and the storage of ``state`` and of the
    ``frozen`` tree it reads (a LoRA base).  It replays on CUDA when every
    group of ``plan`` is NCCL's, else runs eagerly.  Returns the loss as a
    fresh tensor."""
    groups = () if plan is None else plan.groups()
    loss = _graphs.run(programs, name, body, device=device, static=static, inputs=inputs,
                       bound=(state, frozen), mutated=state, donate=True, groups=groups)
    return loss.clone() if _graphs.replays(device, groups) else loss


def make_sharded_train_step(plan: shardlib.MeshPlan, config: ModelConfig,
                            lr: float = 3e-4, n_micro: int | None = None,
                            accum_steps: int = 1, tracer=None):
    """The step over ``plan``: ``step(state, tokens) -> (state, loss)``
    with ``state`` this rank's shards and ``tokens`` this rank's block of
    the global batch.  It updates the shards and the step counter in
    place, as :func:`train_step` does, and returns the global loss.  When
    the plan has pp > 1 the forward runs the GPipe pipeline
    (:mod:`.pipeline`) with ``n_micro`` microbatches (default pp);
    ``accum_steps`` accumulates on top, each accumulation microbatch
    pipelined.

    The reference's jitted step with its state donated: a CUDA-graph
    capture (:func:`donated_step`), not ``torch.jit``, one per state
    storage and token shape, owned by ``step.programs``.  The ids are
    checked on the way into the graph's static buffer.

    With a ``tracer`` (:class:`~.obs.Tracer`) each step records one lap
    group of device spans: ``train.forward`` (the step's start to the loss
    value), ``train.backward`` (to the grads, the collectives and the dp
    mean included) and ``train.optimizer`` (``AdamW.update_`` and the
    counter); with ``accum_steps`` > 1 a name recurs once a microbatch.
    Under replay their events are nodes of the captured graph, which every
    replay records again, so the tracer's export holds the last completed
    step's split.  Without one the graph is the untraced step's, node for
    node."""
    opt = make_optimizer(lr)
    loss = functools.partial(loss_fn, n_micro=n_micro)
    programs = _graphs.Programs()
    programs.tracer = tracer
    if tracer is not None:
        tracer.carry("programs", programs.counts)
    static = (config, lr, n_micro, accum_steps, tuple(plan.axes.items()))

    def body(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        if tracer is not None:
            tracer.lap_group(plan.device)
        loss_value, grads = sharded_loss_and_grads(plan, state.params, tokens, config,
                                                   accum_steps, loss=loss, tracer=tracer)
        opt.update_(grads, state.opt_state, state.params)
        state.step.add_(1)
        if tracer is not None:
            tracer.lap("train.optimizer", plan.device)
        return loss_value

    def step(state: TrainState, tokens: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        tokens = torch.as_tensor(tokens)
        check_token_ids(tokens, config)
        return state, donated_step(programs, "train_step", lambda t: body(state, t), state,
                                   inputs=(tokens,), plan=plan, device=plan.device,
                                   static=static)

    step.programs = programs
    return step
