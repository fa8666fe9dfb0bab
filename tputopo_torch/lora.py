"""LoRA adapters: parameter-efficient finetuning of the flagship LM — the
counterpart of ``tputopo/workloads/lora.py``.

A targeted projection trains a low-rank delta ``x @ a @ b * (alpha/rank)``
beside its frozen weight:

- **Leaf wrapper, not a model fork**: :func:`lora_view` turns a targeted
  leaf into ``{"lora_base": w, "lora_a": [L, d, r], "lora_b": [L, r, out],
  "lora_scale": [L]}`` and :func:`~.quant.qdot`, the one matmul site every
  projection goes through, adds the delta.  The leading layer axis keeps
  the model's per-layer slicing (``model._layer``) as it is, for the
  forward, decode, serving and speculative paths alike.
- **Composes with quantization** (the QLoRA serving shape): the frozen base
  may be an int8 or grouped-int4 leaf; the adapter rides on top of it.
- **Training state is the adapter only**: the optimizer sees the adapter
  tree (``a``, ``b`` and ``scale``, as optax's ``adamw`` over the
  reference's adapter tree does), the base is a frozen argument whose
  tensors never require grad and are never written.  ``b`` starts at zero,
  so step 1's forward equals the base model's exactly.

Sharding (:func:`lora_shardings`, a spec tree as :func:`~.sharding.param_specs`
is): ``a`` and ``scale`` are replicated, ``b``'s output axis follows the
base's column-parallel ``tp`` split, so the delta lands in the block of
the output the base dot produces.  One deviation follows the port's GQA
layout: where tp does not divide the kv heads (:func:`~.sharding.kv_replicated`)
``wk``/``wv`` are whole on every rank, and so is the ``b`` of their
adapters.  The grads of every replicated adapter leaf are partial sums
over tp (each rank contracts its own block of the output) and are summed
over tp, as the sharded step does for the whole ``wk``/``wv``.  Row-parallel
targets (``wo``, ``w_down``) are rejected: their inputs arrive tp-sharded,
and the adapter contraction would need its own all-reduce.

Under ``pp > 1`` the adapter's step runs the forward through the GPipe
pipeline (:mod:`.pipeline`), the adapter's leading layer axis split over
``pp`` with the base's.  Random draws come from a ``torch.Generator``, so
they cannot match ``jax.random``'s; parity tests carry an adapter across
from numpy (:func:`~.convert.lora_from_numpy`).
"""

from __future__ import annotations

import functools
import math

import torch

from tputopo_torch import _graphs
from tputopo_torch import sharding as shardlib
from tputopo_torch.model import ModelConfig, check_token_ids, resolve_device
from tputopo_torch.quant import is_quantized
from tputopo_torch.train import (TrainState, _leaf_names, _leaves,
                                 accumulated_loss_and_grads, donated_step, loss_fn,
                                 make_optimizer, sharded_loss_and_grads)

#: Column-parallel projections LoRA may target ([.., d_in, d_out] with the
#: output axis tp-sharded).  Row-parallel ones (wo, w_down) would need an
#: all-reduce for the adapter contraction: rejected.
_COL_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")
DEFAULT_TARGETS = ("wq", "wv")


def _target_dims(c: ModelConfig, name: str) -> tuple[int, int]:
    return {
        "wq": (c.d_model, c.n_heads * c.head_dim),
        "wk": (c.d_model, c.n_kv_heads * c.head_dim),
        "wv": (c.d_model, c.n_kv_heads * c.head_dim),
        "w_gate": (c.d_model, c.d_ff),
        "w_up": (c.d_model, c.d_ff),
    }[name]


def init_lora(config: ModelConfig, seed: int = 0, *, rank: int = 8,
              alpha: float = 16.0, targets: tuple[str, ...] = DEFAULT_TARGETS,
              device=None) -> dict:
    """Adapter tree ``{"layers": {name: {"a", "b", "scale"}}}``, f32, on
    ``device`` (``cuda`` unless asked for the CPU).

    ``a`` ~ N(0, 1/d) from a generator seeded with ``seed`` (target ``i``
    draws from ``seed + i``), ``b`` = 0, so the delta starts exactly zero;
    ``scale`` carries alpha/rank per layer so a layer's slice is
    self-contained."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if config.mla is not None:
        raise ValueError("LoRA has no latent attention (MLA) support")
    for name in targets:
        if name not in _COL_PARALLEL:
            raise ValueError(
                f"LoRA target {name!r} is not column-parallel; supported: "
                f"{_COL_PARALLEL} (row-parallel targets would need their "
                "own all-reduce)")
        if config.moe is not None and name in ("w_gate", "w_up"):
            raise ValueError(
                f"target {name!r} is an MoE expert table under this "
                "config; adapter routing over experts is not supported")
    dev = resolve_device(device)
    L = config.n_layers
    out = {}
    for i, name in enumerate(targets):
        din, dout = _target_dims(config, name)
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        a = torch.randn((L, din, rank), generator=gen, dtype=torch.float32, device=dev)
        out[name] = {
            "a": a.div_(math.sqrt(din)),
            "b": torch.zeros((L, rank, dout), dtype=torch.float32, device=dev),
            "scale": torch.full((L,), alpha / rank, dtype=torch.float32, device=dev),
        }
    return {"layers": out}


def lora_view(base_params: dict, lora: dict) -> dict:
    """The parameter tree the forward consumes: targeted leaves wrapped as
    LoRA dicts (:func:`~.quant.qdot` adds the delta), everything else the
    frozen base.  Tree surgery only: no base tensor is copied."""
    if "kv_b" in base_params["layers"]:
        raise ValueError("LoRA has no latent attention (MLA) support")
    layers = dict(base_params["layers"])
    for name, ad in lora["layers"].items():
        if name not in layers:
            raise ValueError(f"lora target {name!r} not in base layers")
        layers[name] = {"lora_base": layers[name], "lora_a": ad["a"],
                        "lora_b": ad["b"], "lora_scale": ad["scale"]}
    out = dict(base_params)
    out["layers"] = layers
    return out


@torch.no_grad()
def merge_lora(base_params: dict, lora: dict) -> dict:
    """Fold the adapter into raw float base weights (serving without the
    extra dot); the input trees are left as they are.  A quantized base
    cannot take the delta losslessly: serve it through :func:`lora_view`
    instead (that is the QLoRA shape)."""
    if "kv_b" in base_params["layers"]:
        raise ValueError("LoRA has no latent attention (MLA) support")
    layers = dict(base_params["layers"])
    for name, ad in lora["layers"].items():
        w = layers[name]
        if is_quantized(w):
            raise ValueError(
                f"cannot merge into quantized base leaf {name!r}; serve "
                "via lora_view instead")
        delta = torch.einsum("ldr,lro->ldo", ad["a"], ad["b"])
        layers[name] = w + delta * ad["scale"][:, None, None]
    out = dict(base_params)
    out["layers"] = layers
    return out


def lora_shardings(plan: shardlib.MeshPlan, lora: dict, config: ModelConfig | None = None
                   ) -> dict:
    """The adapter tree's layout under ``plan``, as axis names per dimension
    (the reference's NamedShardings, read as :func:`~.sharding.param_specs`
    reads them): ``a`` and ``scale`` replicated, ``b``'s output axis over
    ``tp``, except the ``b`` of a ``wk``/``wv`` adapter where ``config``'s
    kv heads are kept whole (:func:`~.sharding.kv_replicated`)."""
    s = plan.spec
    pp = "pp" if plan.size("pp") > 1 else None
    kv_whole = shardlib.kv_replicated(plan, config)

    def leaf(target: str, name: str) -> tuple:
        if name == "b":
            out = None if kv_whole and target in ("wk", "wv") else "tp"
            return s(pp, None, out)
        if name == "a":
            return s(pp, None, None)
        return s(pp)  # scale [L]

    return {"layers": {t: {k: leaf(t, k) for k in ad}
                       for t, ad in lora["layers"].items()}}


def _lora_loss(base_params: dict, adapter: dict, tokens: torch.Tensor,
               config: ModelConfig, n_micro: int | None = None) -> torch.Tensor:
    return loss_fn(lora_view(base_params, adapter), tokens, config, n_micro)


def lora_train_step(state: TrainState, base_params: dict, tokens: torch.Tensor,
                    config: ModelConfig, lr: float = 3e-4,
                    accum_steps: int = 1) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step of the adapter on one device, in place (the step
    counter included), as :func:`~.train.train_step` is for the model:
    grads flow to the adapter tree ``state.params`` only; ``base_params``
    (raw or quantized) is read, never written."""
    loss, grads = accumulated_loss_and_grads(
        state.params, tokens, config, accum_steps,
        functools.partial(_lora_loss, base_params))
    make_optimizer(lr).update_(grads, state.opt_state, state.params)
    state.step.add_(1)
    return state, loss


def make_sharded_lora_train_step(plan: shardlib.MeshPlan, config: ModelConfig,
                                 lora: dict, lr: float = 3e-4,
                                 n_micro: int | None = None,
                                 accum_steps: int = 1):
    """The adapter's step over ``plan``: ``step(lora_state, base_params,
    tokens) -> (lora_state, loss)`` with the state and the base this rank's
    shards (:func:`lora_shardings`, :func:`~.sharding.param_specs`) and
    ``tokens`` this rank's block of the batch.  Local loss and adapter
    grads, the replicated leaves' grads summed over tp, then every grad's
    mean over dp, then AdamW on the adapter shards in place; the global
    loss is returned.  ``lora`` gives the adapter's structure.  When the
    plan has pp > 1 the forward runs the GPipe pipeline with ``n_micro``
    microbatches (default pp), as the model's sharded step does.

    The reference's jitted step with the adapter state donated: a
    CUDA-graph capture (:func:`~.train.donated_step`), not ``torch.jit``,
    one per state and base storage and token shape, owned by
    ``step.programs``; the base is bound, read in place, never written."""
    specs = _leaves(lora_shardings(plan, lora, config))
    tp_partial = tuple(n for n, spec in zip(_leaf_names(lora), specs)
                       if "tp" not in spec)
    opt = make_optimizer(lr)
    programs = _graphs.Programs()
    static = (config, lr, n_micro, accum_steps, tuple(plan.axes.items()))

    def body(state: TrainState, base_params: dict, tokens: torch.Tensor) -> torch.Tensor:
        loss, grads = sharded_loss_and_grads(
            plan, state.params, tokens, config, accum_steps,
            loss=functools.partial(_lora_loss, base_params, n_micro=n_micro),
            tp_partial=tp_partial)
        opt.update_(grads, state.opt_state, state.params)
        state.step.add_(1)
        return loss

    def step(state: TrainState, base_params: dict,
             tokens: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        tokens = torch.as_tensor(tokens)
        check_token_ids(tokens, config)
        return state, donated_step(
            programs, "lora_train_step", lambda t: body(state, base_params, t), state,
            inputs=(tokens,), plan=plan, device=plan.device, static=static,
            frozen=base_params)

    step.programs = programs
    return step


def make_sharded_lora_state(plan: shardlib.MeshPlan, config: ModelConfig,
                            seed: int = 0, *, rank: int = 8, alpha: float = 16.0,
                            targets: tuple[str, ...] = DEFAULT_TARGETS,
                            lr: float = 3e-4) -> TrainState:
    """This rank's shards of a fresh adapter TrainState on the plan's
    device: :func:`init_lora` from ``seed`` (every rank draws the same
    tree), cut per :func:`lora_shardings`, zeroed AdamW moments."""
    lora = init_lora(config, seed, rank=rank, alpha=alpha, targets=targets,
                     device=plan.device)
    params = shardlib.shard_tree(lora, lora_shardings(plan, lora, config), plan)
    return TrainState(params=params, opt_state=make_optimizer(lr).init(params),
                      step=torch.zeros((), dtype=torch.int32, device=plan.device))
