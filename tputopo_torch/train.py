"""Training step for the flagship LM on one device — the counterpart of the
single-device part of ``tputopo/workloads/train.py``.

:func:`train_step` is forward, next-token cross-entropy, grads and one
AdamW update, with optional gradient accumulation over microbatches.  The
optimizer is optax's ``adamw`` written out (:func:`make_optimizer`), and its
state mirrors optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``), so a
JAX ``TrainState`` converts leaf for leaf (:mod:`tputopo_torch.convert`).

Where the reference returns a new state, :func:`train_step` updates the
parameters and moments in place and returns the same tensors in a new
``TrainState``: at Llama-3-8B width a second copy of them would not fit on
one card.  The reference's sharded step donates its state buffers for the
same reason.  The sharded, pipelined and MoE steps come with the multi-GPU
slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tputopo_torch.model import (ModelConfig, forward_with_aux, init_params,
                                 resolve_device)


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
    dropped), from an f32 ``log_softmax``, plus the auxiliary loss."""
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


def train_step(state: TrainState, tokens: torch.Tensor, config: ModelConfig,
               lr: float = 3e-4, accum_steps: int = 1) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step, in place; returns (state, loss).

    ``accum_steps > 1`` splits the batch into that many microbatches, runs
    forward and backward on each in turn and sums their grads, then applies
    ONE update with the mean: activation memory drops to one microbatch's
    worth while the update sees the full-batch gradient (exactly, for the
    dense model: cross-entropy means over equal chunks average to the
    full mean)."""
    if accum_steps <= 1:
        loss, grads = loss_and_grads(state.params, tokens, config)
    else:
        B = tokens.shape[0]
        if B % accum_steps:
            raise ValueError(
                f"batch {B} not divisible by accum_steps {accum_steps}")
        loss, grads = 0.0, None
        for mb in tokens.reshape(accum_steps, B // accum_steps, tokens.shape[1]):
            l, g = loss_and_grads(state.params, mb, config)
            loss = loss + l
            grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
        loss = loss / accum_steps
        grads = [g.div_(accum_steps) for g in grads]
    make_optimizer(lr).update_(grads, state.opt_state, state.params)
    return TrainState(params=state.params, opt_state=state.opt_state,
                      step=state.step + 1), loss
