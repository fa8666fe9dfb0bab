"""Llama-style decoder-only LM in PyTorch — the counterpart of
``tputopo/workloads/model.py``.

The parameters keep the reference's layout: per-layer tensors stacked on a
leading layer axis, matmul weights ``[L, in, out]`` contracted as
``x @ w`` (not ``nn.Linear``'s ``[out, in]``), so a JAX parameter tree
converts leaf for leaf (:mod:`tputopo_torch.convert`).  Compute runs in
``compute_dtype`` over float32 masters, as in the reference.

Where JAX scans over the stacked layers, this module loops in Python.
Attention goes through the port's flash kernels (:mod:`.attention`) when
``attn_impl`` resolves to flash, and through an einsum path otherwise.

The forward is differentiable (:mod:`tputopo_torch.train` takes its
grads).  When a backward pass is being recorded, ``remat`` takes effect
per layer as in the reference's ``apply_remat``: ``"block"`` checkpoints
the whole layer and recomputes it in the backward, ``"dots"`` keeps the
matmul outputs and the flash forward's ``(o, lse)`` and recomputes the
rest, ``"none"`` keeps everything.

Weights may be raw tensors or the int8/int4 leaves of :mod:`.quant`.
Under an active mesh plan (:func:`.sharding.activate`) with ``tp > 1``
the forward runs Megatron's tensor-parallel split on each rank's local
shards, with the collectives written out: ``wq``/``wk``/``wv``/``w_gate``/
``w_up`` hold a block of output features, ``wo``/``w_down`` a block of input
features, ``lm_head`` a block of the vocab.  A pair of autograd functions
carries every collective: :func:`copy_to_tp` (identity forward, all-reduce
of the gradient backward) where a replicated activation enters a
column-parallel block, and :func:`reduce_from_tp` (all-reduce forward,
identity backward) where a row-parallel block's partial sums leave it.  So
each block costs one all-reduce forward and one backward, all of them
``all_reduce`` calls, which NCCL and gloo both carry.  Each rank runs
attention, through the flash kernels, on its ``n_heads / tp`` heads.  When
tp does not divide the kv heads, ``wk``/``wv`` stay whole on every rank and
each rank takes the kv heads its q heads read (:func:`.sharding.kv_replicated`).

What the port leaves out so far raises ``NotImplementedError``: MoE
layers (``moe``), LoRA weight leaves, and plans with ``pp``, ``sp`` or
``ep`` above 1.  The reference's context-parallel strategies (``sp_impl``)
act only under a plan with ``sp > 1``; the port keeps the field and its
eager check so configs carry over.  The reference's ``constrain``
annotations are the identity here (:func:`.sharding.constrain`): the
collectives above carry the layout.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``); with no GPU and no such request they raise.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tputopo_torch.attention import flash_attention
from tputopo_torch.quant import deq_rows, is_quantized, qdot


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else ``cuda``; raise rather than fall back to
    the CPU when no GPU is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tputopo_torch runs on the GPU by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family hyperparameters, with the reference's fields and
    defaults.  ``llama3_8b()`` is the north-star model; ``tiny()`` its
    CPU-test twin."""

    vocab_size: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    max_seq: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.bfloat16
    # "auto": the flash kernel on a CUDA device when shapes allow, einsum
    # elsewhere.  "flash" forces it (its plain version on the CPU);
    # "einsum" disables it.
    attn_impl: str = "auto"
    sp_impl: str = "ring"
    remat: str = "block"
    moe: "object | None" = None
    kv_dtype: str = "bf16"

    SP_IMPLS = ("ring", "a2a")
    REMATS = ("block", "dots", "none")

    def __post_init__(self):
        if self.sp_impl not in self.SP_IMPLS:
            raise ValueError(
                f"unknown sp_impl {self.sp_impl!r} (want one of "
                f"{self.SP_IMPLS})")

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @staticmethod
    def tiny(**kw) -> "ModelConfig":
        return ModelConfig(**kw)

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq=8192,
        )


def _check_supported(c: ModelConfig) -> None:
    if c.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet: they come "
                                  "with the MoE slice of tputopo_torch")
    if c.remat not in c.REMATS:
        raise ValueError(f"unknown remat policy {c.remat!r}")


def init_params(config: ModelConfig, seed: int = 0, *, device=None,
                cut=None) -> dict:
    """Parameter dict in the reference's stacked layout, f32, drawn from
    a ``torch.Generator`` seeded with ``seed`` on the target device.

    ``cut(path, leaf)``, when given, replaces each leaf (``path`` its tuple
    of keys) as soon as it is drawn, before the next is drawn: the sharded
    state keeps only its block of each, so the whole tree is never held."""
    c = config
    _check_supported(c)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = cut or (lambda path, leaf: leaf)

    def norm_init(path, shape):
        return keep(path, torch.ones(shape, dtype=torch.float32, device=dev))

    def dense_init(path, shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return keep(path, w.mul_(1.0 / math.sqrt(fan_in)))

    L, D, H, KV, Hd, Fd = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                           c.head_dim, c.d_ff)
    return {  # the dict order is the draw order
        "embed": dense_init(("embed",), (c.vocab_size, D), D),
        "layers": {
            "attn_norm": norm_init(("layers", "attn_norm"), (L, D)),
            "wq": dense_init(("layers", "wq"), (L, D, H * Hd), D),
            "wk": dense_init(("layers", "wk"), (L, D, KV * Hd), D),
            "wv": dense_init(("layers", "wv"), (L, D, KV * Hd), D),
            "wo": dense_init(("layers", "wo"), (L, H * Hd, D), H * Hd),
            "mlp_norm": norm_init(("layers", "mlp_norm"), (L, D)),
            "w_gate": dense_init(("layers", "w_gate"), (L, D, Fd), D),
            "w_up": dense_init(("layers", "w_up"), (L, D, Fd), D),
            "w_down": dense_init(("layers", "w_down"), (L, Fd, D), Fd),
        },
        "final_norm": norm_init(("final_norm",), (D,)),
        "lm_head": dense_init(("lm_head",), (D, c.vocab_size), D),
    }


def _rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * weight).to(x.dtype)


def _rope_tables(config: ModelConfig, seq: int, device) -> tuple:
    half = config.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(config.rope_theta, dtype=torch.float32,
                                   device=device), exponent)
    angles = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
              * freqs[None, :])
    return torch.cos(angles), torch.sin(angles)  # each [S, Hd/2]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, N, Hd] -> rotated.  As in the reference, the rotation
    pairs feature i with feature i + Hd/2 (the two halves), not
    interleaved (even, odd) pairs."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


def _attention(x: torch.Tensor, p: dict, config: ModelConfig,
               cos: torch.Tensor, sin: torch.Tensor, tp=None) -> torch.Tensor:
    c = config
    B, S, D = x.shape
    n_heads, n_kv = c.n_heads, c.n_kv_heads
    if tp is not None:
        x = copy_to_tp(x, tp.group)
        n_heads //= tp.size
        if not tp.kv_replicated:
            n_kv //= tp.size
    q = qdot(x, p["wq"]).reshape(B, S, n_heads, c.head_dim)
    k = qdot(x, p["wk"]).reshape(B, S, n_kv, c.head_dim)
    v = qdot(x, p["wv"]).reshape(B, S, n_kv, c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    group = c.n_heads // c.n_kv_heads
    if tp is not None and tp.kv_replicated:
        # this rank's q head i is global head rank * n_heads + i, which
        # reads kv head (rank * n_heads + i) // group of the whole set
        idx = (torch.arange(n_heads, device=x.device) + tp.rank * n_heads) // group
        k, v = k[:, :, idx], v[:, :, idx]
    elif group > 1:
        # query head n reads kv head n // group (jnp.repeat's order)
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)

    if _use_flash(c, S, x.device):
        out = _flash_dispatch(q, k, v)
    else:
        scale = 1.0 / math.sqrt(c.head_dim)
        logits = torch.einsum("bqnh,bknh->bnqk", q, k) * scale
        pos = torch.arange(S, device=x.device)
        logits = logits.masked_fill(pos[None, :] > pos[:, None],
                                    torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bnqk,bknh->bqnh", probs, v)
    out = qdot(out.reshape(B, S, n_heads * c.head_dim), p["wo"])
    return out if tp is None else reduce_from_tp(out, tp.group)


def _use_flash(c: ModelConfig, seq: int, device: torch.device) -> bool:
    if c.attn_impl == "einsum":
        return False
    block = min(128, seq)
    # Block must divide seq and be 8-aligned; without the alignment term
    # any seq <= 128 trivially divides itself.
    shapes_ok = seq >= 16 and seq % block == 0 and block % 8 == 0
    if c.attn_impl == "flash":
        if not shapes_ok:
            raise ValueError(
                f"attn_impl=flash needs seq >= 16, divisible by {block}, "
                f"block 8-aligned; got seq={seq}")
        return True
    if c.attn_impl != "auto":
        raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
    # The same shape rule that picks the kernel on a TPU, on a CUDA card,
    # and the head dims the kernels take (a multiple of 8 in [8, 128]).
    head_ok = c.head_dim % 8 == 0 and 8 <= c.head_dim <= 128
    return block == 128 and shapes_ok and head_ok and device.type == "cuda"


def _flash_dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention on one card.  The block sizes only carry the
    reference's shape contract; the kernel tiles on its own."""
    block = min(128, q.shape[1])
    return flash_attention(q, k, v, causal=True, block_q=block, block_kv=block)


def _mlp(x: torch.Tensor, p: dict, tp=None) -> torch.Tensor:
    if tp is not None:
        x = copy_to_tp(x, tp.group)
    gate = F.silu(qdot(x, p["w_gate"]))
    up = qdot(x, p["w_up"])
    y = qdot(gate * up, p["w_down"])
    return y if tp is None else reduce_from_tp(y, tp.group)


def transformer_block(x: torch.Tensor, layer: dict, config: ModelConfig,
                      cos: torch.Tensor, sin: torch.Tensor, tp=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer: (x, one layer's params) -> (x, aux loss), aux 0
    for the dense FFN.  ``tp`` (:func:`tp_context`) runs it on this rank's
    shards."""
    c = config
    h = x + _attention(_rmsnorm(x, layer["attn_norm"], c.norm_eps), layer, c,
                       cos, sin, tp)
    y = _mlp(_rmsnorm(h, layer["mlp_norm"], c.norm_eps), layer, tp)
    return h + y, torch.zeros((), dtype=torch.float32, device=x.device)


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked tree: every tensor indexed on its leading
    axis, including each array inside a quantized leaf."""
    def take(w):
        return {k: take(a) for k, a in w.items()} if isinstance(w, dict) else w[i]

    return {name: take(w) for name, w in layers.items()}


# What remat="dots" keeps: every matmul output (the reference's
# dots_saveable) and the flash forward's (o, lse), its "flash_out" and
# "flash_lse" names.  A selective-checkpoint policy sees dispatcher ops, so
# the flash launch is the op tputopo::flash_fwd (attention.py).
_DOTS_SAVED = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                         torch.ops.tputopo.flash_fwd.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(block_fn, remat: str):
    """Wrap one layer's function per the ``remat`` policy."""
    if remat == "block":
        return functools.partial(checkpoint, block_fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, block_fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    if remat == "none":
        return block_fn
    raise ValueError(f"unknown remat policy {remat!r}")


def _block_loop(x: torch.Tensor, layers: dict, config: ModelConfig,
                cos: torch.Tensor, sin: torch.Tensor,
                tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    block = transformer_block
    recording = torch.is_grad_enabled() and (x.requires_grad or any(
        torch.is_tensor(w) and w.requires_grad for w in layers.values()))
    if recording:  # remat is a memory policy of the backward pass only
        block = apply_remat(transformer_block, config.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = block(x, _layer(layers, i), config, cos, sin, tp)
        aux = aux + a
    return x, aux


def embed_tokens(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    # JAX clamps an out-of-range id silently and torch would fault on the
    # card: reject it here.
    if tokens.numel() and (int(tokens.min()) < 0
                           or int(tokens.max()) >= config.vocab_size):
        raise ValueError(f"token ids must lie in [0, {config.vocab_size}); "
                         f"got [{int(tokens.min())}, {int(tokens.max())}]")
    return deq_rows(params["embed"], tokens, config.compute_dtype)


def lm_head(params: dict, x: torch.Tensor, config: ModelConfig,
            tp=None) -> torch.Tensor:
    """Final norm and head -> f32 logits.  The head is rounded to
    ``compute_dtype`` as in the reference, and the product of the two
    compute-dtype operands accumulates in f32 without rounding the logits:
    both operands are widened to f32, where bf16 products are exact.  A
    quantized head contracts the f32 activations (:func:`.quant.qdot`).
    Under ``tp`` the logits are this rank's block of the vocab."""
    x = _rmsnorm(x, params["final_norm"], config.norm_eps)
    if tp is not None:
        x = copy_to_tp(x, tp.group)
    w = params["lm_head"]
    if is_quantized(w):
        return qdot(x.float(), w)
    return x.float() @ w.to(config.compute_dtype).float()


def trunk(params: dict, tokens: torch.Tensor, config: ModelConfig,
          tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (the last layer's output [B, S, D] in
    ``compute_dtype``, aux loss scalar), on the device of ``params``."""
    c = config
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens, device=device)
    cos, sin = _rope_tables(c, tokens.shape[1], device)
    x = embed_tokens(params, tokens, c)
    return _block_loop(x, params["layers"], c, cos, sin, tp)


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     config: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (logits [B, S, vocab] f32, aux loss scalar), on
    the device that holds ``params``; differentiable in the parameters.
    Under an active plan with tp > 1, ``params`` are this rank's shards
    and the vocab blocks are gathered into whole logits."""
    _check_supported(config)
    tp = tp_context(config)
    x, aux = trunk(params, tokens, config, tp)
    logits = lm_head(params, x, config, tp)
    if tp is not None:
        logits = _GatherFromTP.apply(logits, tp)
    return logits, aux


def forward(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (float32)."""
    return forward_with_aux(params, tokens, config)[0]


# ---- tensor parallelism -----------------------------------------------------

@dataclass(frozen=True)
class TensorParallel:
    """This rank's place in the active plan's tp group."""

    group: object  # the tp process group
    size: int
    rank: int
    kv_replicated: bool


def tp_context(config: ModelConfig) -> TensorParallel | None:
    """The tp group of the active plan (:func:`.sharding.activate`), or
    None when no plan is active or tp is 1.  Raises for what the split
    cannot take and for the axes the port does not run yet."""
    from tputopo_torch.sharding import active_plan, kv_replicated

    plan = active_plan()
    if plan is None:
        return None
    plan.check_supported()
    tp = plan.size("tp")
    if tp == 1:
        return None
    c = config
    for name, n in (("n_heads", c.n_heads), ("d_ff", c.d_ff),
                    ("vocab_size", c.vocab_size)):
        if n % tp:
            raise ValueError(f"tp={tp} does not divide {name}={n}")
    return TensorParallel(group=plan.group("tp"), size=tp, rank=plan.rank("tp"),
                          kv_replicated=kv_replicated(plan, c))


def all_reduce_f32(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A fresh tensor: the all-reduce of ``x`` over ``group``, taken in f32
    (the partial sums of a bf16 block add without further rounding) and
    returned in ``x``'s dtype."""
    y = x.detach().to(torch.float32, memory_format=torch.contiguous_format,
                      copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over tp backward: the
    replicated input of a column-parallel block gets every rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward; identity backward: a row-parallel block's
    partial sums become the replicated output."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather of the last dim's blocks forward; this rank's block of
    the gradient backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.tp.size, dim=-1)[ctx.tp.rank], None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)
