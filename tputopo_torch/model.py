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

Weights may be raw tensors, the int8/int4 leaves of :mod:`.quant`, or
LoRA-wrapped leaves (:mod:`.lora`).
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

An MoE config (``moe``, :mod:`.moe`) replaces every layer's FFN by the
expert layer, whose experts split over the plan's ``ep`` axis.  Under a
plan with ``sp > 1`` each rank holds a chunk of the sequence: RoPE takes
the chunk's global positions, and ``attn_impl="auto"`` runs the
context-parallel strategy ``sp_impl`` names, ring (:mod:`.ring`) or
all-to-all (:mod:`.ulysses`), as the reference's ``_ring_plan`` does; a
forced ``"flash"`` or ``"einsum"`` gathers the sequence and attends over
all of it.  Under ``pp > 1`` the layer stack runs as the GPipe pipeline
(:mod:`.pipeline`).  The reference's ``constrain`` annotations are the
identity here (:func:`.sharding.constrain`): the collectives above carry
the layout.

:func:`forward_jit`, the reference's compiled forward, replays one
CUDA-graph capture of :func:`forward` (:mod:`._graphs`).

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

from tputopo_torch import _graphs
from tputopo_torch.attention import flash_attention, head_dim_ok
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
    # Multi-head latent attention (:class:`~.mla.MLAConfig`) in every layer
    # in place of GQA; its head widths are its own, not d_model / n_heads.
    mla: "object | None" = None

    SP_IMPLS = ("ring", "a2a")
    REMATS = ("block", "dots", "none")

    def __post_init__(self):
        if self.sp_impl not in self.SP_IMPLS:
            raise ValueError(
                f"unknown sp_impl {self.sp_impl!r} (want one of "
                f"{self.SP_IMPLS})")

    @property
    def head_dim(self) -> int:
        if self.mla is not None:
            raise ValueError("an MLA config's head widths are its mla's "
                             "(nope, rope, v), not d_model / n_heads")
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
    if c.remat not in c.REMATS:
        raise ValueError(f"unknown remat policy {c.remat!r}")


def check_plain(c: ModelConfig, what: str) -> None:
    """Refuse, naming ``what``, a config with what only the serving path's
    cached layers support: latent attention (MLA), or an expert layout
    beyond Mixtral's (leading dense layers, shared experts, sigmoid or
    group-limited routing, a share of the experts held)."""
    if c.mla is not None:
        raise ValueError(f"{what} has no latent attention (MLA) support; "
                         "serve an MLA config through ServingEngine or generate")
    m = c.moe
    if m is not None and (m.first_dense or m.n_shared or m.scoring != "softmax"
                          or m.held is not None):
        raise ValueError(f"{what} supports Mixtral's expert layer only (no "
                         "leading dense layers, shared experts, sigmoid routing "
                         "or held share)")


def n_dense(c: ModelConfig) -> int:
    """The layers whose FFN is the dense SwiGLU: all of a dense config's,
    the leading ``first_dense`` of an expert config's."""
    return c.n_layers if c.moe is None else c.moe.first_dense


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

    L, D, Fd = c.n_layers, c.d_model, c.d_ff
    # the dict order is the draw order
    embed = dense_init(("embed",), (c.vocab_size, D), D)
    if c.mla is not None:
        from tputopo_torch.mla import init_layers

        layers = init_layers(
            c, L, lambda name, shape: norm_init(("layers", name), shape),
            lambda name, shape, fan_in: dense_init(("layers", name), shape, fan_in))
    else:
        H, KV, Hd = c.n_heads, c.n_kv_heads, c.head_dim
        layers = {
            "attn_norm": norm_init(("layers", "attn_norm"), (L, D)),
            "wq": dense_init(("layers", "wq"), (L, D, H * Hd), D),
            "wk": dense_init(("layers", "wk"), (L, D, KV * Hd), D),
            "wv": dense_init(("layers", "wv"), (L, D, KV * Hd), D),
            "wo": dense_init(("layers", "wo"), (L, H * Hd, D), H * Hd),
            "mlp_norm": norm_init(("layers", "mlp_norm"), (L, D)),
        }
    K = n_dense(c)
    if K:  # the dense layers' FFN: all of them, or the leading ones
        layers["w_gate"] = dense_init(("layers", "w_gate"), (K, D, Fd), D)
        layers["w_up"] = dense_init(("layers", "w_up"), (K, D, Fd), D)
        layers["w_down"] = dense_init(("layers", "w_down"), (K, Fd, D), Fd)
    if c.moe is not None:
        from tputopo_torch.moe import init_moe_params

        layers["moe"] = init_moe_params(c, dense=lambda name, shape, fan_in: dense_init(
            ("layers", "moe", name), shape, fan_in))
    return {"embed": embed, "layers": layers,
            "final_norm": norm_init(("final_norm",), (D,)),
            "lm_head": dense_init(("lm_head",), (D, c.vocab_size), D)}


def _rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * weight).to(x.dtype)


def _rope_tables(config: ModelConfig, seq: int, device) -> tuple:
    """(cos, sin), each [S, Hd/2] f32.  theta stays a 0-dim CPU tensor,
    which a CUDA op takes as a kernel argument: no host-to-device copy, so
    a CUDA graph capture records the tables' few kernels like any others.
    An MLA config's are its rope features' YaRN tables (:func:`.mla.rope_tables`)."""
    if config.mla is not None:
        from tputopo_torch.mla import rope_tables

        return rope_tables(config.mla, config.rope_theta, seq, device)
    half = config.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = torch.pow(torch.tensor(config.rope_theta, dtype=torch.float32), exponent)
    angles = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
              * freqs[None, :])
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, N, Hd] -> rotated, at the positions whose rows cos/sin
    hold: [S, Hd/2] shared by the batch, or [B, S, Hd/2] per row (the
    serving step's slots, each at its own position).  As in the reference,
    the rotation pairs feature i with feature i + Hd/2 (the two halves),
    not interleaved (even, odd) pairs."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
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
    kv_group = group
    if tp is not None and tp.kv_replicated:
        # this rank's q head i is global head rank * n_heads + i, which
        # reads kv head (rank * n_heads + i) // group of the whole set
        idx = (torch.arange(n_heads, device=x.device) + tp.rank * n_heads) // group
        k, v, kv_group = k[:, :, idx], v[:, :, idx], 1

    plan = _ring_plan(c)
    if plan is not None:
        # Context parallelism: the sequence stays split over sp.  The
        # narrow GQA K/V travels (rotates around the ring, or crosses the
        # all-to-all) when its local head count allows, else it is
        # expanded first.
        from tputopo_torch.ring import ring_attention

        attn = ring_attention
        if c.sp_impl == "a2a":
            from tputopo_torch.ulysses import a2a_attention

            if kv_group > 1 and k.shape[2] % plan.size("sp"):
                k = k.repeat_interleave(kv_group, dim=2)
                v = v.repeat_interleave(kv_group, dim=2)
                kv_group = 1
            attn = a2a_attention
        out = attn(q, k, v, plan, causal=True, kv_group=kv_group)
        out = qdot(out.reshape(B, S, n_heads * c.head_dim), p["wo"])
        return out if tp is None else reduce_from_tp(out, tp.group)

    if kv_group > 1:
        # query head n reads kv head n // group (jnp.repeat's order)
        k = k.repeat_interleave(kv_group, dim=2)
        v = v.repeat_interleave(kv_group, dim=2)
    sp_plan = _sp_plan()
    if sp_plan is not None:
        # a forced attn_impl under sp: attend over the whole sequence
        q, k, v = (_GatherSeq.apply(t, sp_plan) for t in (q, k, v))
        S = q.shape[1]

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
    if sp_plan is not None:
        out = out.chunk(sp_plan.size("sp"), dim=1)[sp_plan.rank("sp")]
        S = out.shape[1]
    out = qdot(out.reshape(B, S, n_heads * c.head_dim), p["wo"])
    return out if tp is None else reduce_from_tp(out, tp.group)


def _sp_plan():
    """The active plan when it splits the sequence (sp > 1), else None."""
    from tputopo_torch.sharding import active_plan

    plan = active_plan()
    return plan if plan is not None and plan.size("sp") > 1 else None


def _ring_plan(c: ModelConfig):
    """The active plan when context-parallel attention applies: attn_impl
    "auto" and sp > 1 (this rank's chunk divides evenly by construction:
    :func:`~.sharding.local_batch` splits it).  A forced "flash" or
    "einsum" keeps its documented meaning and never reroutes here."""
    return _sp_plan() if c.attn_impl == "auto" else None


class _GatherSeq(torch.autograd.Function):
    """The sequence chunks of every sp rank, in rank order, forward; the
    sum over sp of the gradient, this rank's chunk of it, backward (the
    objective sums the sp ranks' losses)."""

    @staticmethod
    def forward(ctx, x, plan):
        from tputopo_torch.sharding import all_gather

        ctx.plan = plan
        return torch.cat(all_gather(x, plan.group("sp")), dim=1)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = all_reduce_f32(g, plan.group("sp"))
        return g.chunk(plan.size("sp"), dim=1)[plan.rank("sp")].contiguous(), None


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
    # and the head dims the kernels take.
    return (block == 128 and shapes_ok and head_dim_ok(c.head_dim)
            and device.type == "cuda")


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
    for the dense FFN and the router's load-balancing loss for an MoE
    layer.  ``tp`` (:func:`tp_context`) runs it on this rank's shards."""
    c = config
    h = x + _attention(_rmsnorm(x, layer["attn_norm"], c.norm_eps), layer, c,
                       cos, sin, tp)
    pre = _rmsnorm(h, layer["mlp_norm"], c.norm_eps)
    if c.moe is not None:
        from tputopo_torch.moe import moe_mlp

        y, aux = moe_mlp(pre, layer["moe"], c, tp)
    else:
        y, aux = _mlp(pre, layer, tp), torch.zeros((), dtype=torch.float32,
                                                   device=x.device)
    return h + y, aux


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked tree: every tensor indexed on its leading
    axis, including each array inside a quantized or LoRA leaf."""
    def take(w):
        return {k: take(a) for k, a in w.items()} if isinstance(w, dict) else w[i]

    return {name: take(w) for name, w in layers.items()}


_DENSE_FFN = ("w_gate", "w_up", "w_down")


def layer_at(layers: dict, config: ModelConfig, i: int) -> dict:
    """Layer ``i`` of the stacked tree under ``config``'s FFN layout: the
    dense FFN's leaves are stacked over the leading :func:`n_dense` layers
    and the expert layer's (``moe``) over the rest, so layer ``i`` holds
    one or the other.  :func:`_layer` where every layer has the same kind."""
    K = n_dense(config)
    if K in (0, config.n_layers):
        return _layer(layers, i)
    ffn = _DENSE_FFN if i < K else ("moe",)
    shared = {k: w for k, w in layers.items() if k not in _DENSE_FFN and k != "moe"}
    return {**_layer(shared, i),
            **_layer({k: layers[k] for k in ffn}, i if i < K else i - K)}


def _requires_grad(tree) -> bool:
    """Whether any tensor of a nested dict requires grad (a LoRA adapter's
    leaves sit inside the weight dicts)."""
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return torch.is_tensor(tree) and tree.requires_grad


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
    """Wrap one layer's function per the ``remat`` policy.  A block draws
    no random numbers, so the checkpoint keeps no RNG state: reading the
    CUDA generator's state is refused while a CUDA graph captures, and
    the training steps are captured (:mod:`._graphs`)."""
    if remat == "block":
        return functools.partial(checkpoint, block_fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, block_fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    if remat == "none":
        return block_fn
    raise ValueError(f"unknown remat policy {remat!r}")


def _block_loop(x: torch.Tensor, layers: dict, config: ModelConfig,
                cos: torch.Tensor, sin: torch.Tensor,
                tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    block = transformer_block
    recording = torch.is_grad_enabled() and (x.requires_grad
                                             or _requires_grad(layers))
    if recording:  # remat is a memory policy of the backward pass only
        block = apply_remat(transformer_block, config.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = block(x, _layer(layers, i), config, cos, sin, tp)
        aux = aux + a
    return x, aux


def check_token_ids(tokens: torch.Tensor, config: ModelConfig) -> None:
    """JAX clamps an out-of-range id silently and torch would fault on the
    card: reject it (a readback when ``tokens`` lie on the card)."""
    if tokens.numel() and (int(tokens.min()) < 0
                           or int(tokens.max()) >= config.vocab_size):
        raise ValueError(f"token ids must lie in [0, {config.vocab_size}); "
                         f"got [{int(tokens.min())}, {int(tokens.max())}]")


def embed_tokens(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """The ids' rows of the embedding, after :func:`check_token_ids`.  A CUDA
    graph cannot record the check's readback: under a capture the compiled
    program has checked its input where it entered the static buffer."""
    if not _graphs.capturing(tokens.device):
        check_token_ids(tokens, config)
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


def rope_for_rank(config: ModelConfig, seq: int, device) -> tuple:
    """The RoPE tables of this rank's ``seq`` positions: under an active
    plan with sp > 1 the sequence is split over sp, and the chunk of rank
    ``r`` holds the global positions ``r * seq ...``."""
    plan = _sp_plan()
    if plan is None:
        return _rope_tables(config, seq, device)
    cos, sin = _rope_tables(config, seq * plan.size("sp"), device)
    r = plan.rank("sp")
    return cos[r * seq:(r + 1) * seq], sin[r * seq:(r + 1) * seq]


def trunk(params: dict, tokens: torch.Tensor, config: ModelConfig,
          tp=None, n_micro: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (the last layer's output [B, S, D] in
    ``compute_dtype``, aux loss scalar), on the device of ``params``.
    Under an active plan with pp > 1 the layers run as the GPipe pipeline
    with ``n_micro`` microbatches (:mod:`.pipeline`)."""
    from tputopo_torch.sharding import active_plan

    check_plain(config, "the training forward")
    plan = active_plan()
    if plan is not None and plan.size("pp") > 1:
        from tputopo_torch.pipeline import pipelined_trunk

        return pipelined_trunk(params, tokens, config, plan, n_micro, tp)
    c = config
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens, device=device)
    cos, sin = rope_for_rank(c, tokens.shape[1], device)
    x = embed_tokens(params, tokens, c)
    return _block_loop(x, params["layers"], c, cos, sin, tp)


def forward_with_aux(params: dict, tokens: torch.Tensor, config: ModelConfig,
                     n_micro: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (logits [B, S, vocab] f32, aux loss scalar), on
    the device that holds ``params``; differentiable in the parameters.
    Under an active plan, ``params`` are this rank's shards and ``tokens``
    its block of the batch (:func:`~.sharding.local_batch`): the logits
    are those of its rows and, under sp, of its chunk of the sequence,
    with the vocab blocks of tp > 1 gathered whole.  ``n_micro`` sets the
    GPipe microbatches under pp > 1 (:func:`trunk`)."""
    _check_supported(config)
    tp = tp_context(config)
    x, aux = trunk(params, tokens, config, tp, n_micro)
    logits = lm_head(params, x, config, tp)
    if tp is not None:
        logits = _GatherFromTP.apply(logits, tp)
    return logits, aux


def forward(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (float32)."""
    return forward_with_aux(params, tokens, config)[0]


@torch.no_grad()
def forward_jit(params: dict, tokens: torch.Tensor, config: ModelConfig, *,
                programs=None) -> torch.Tensor:
    """:func:`forward` as one compiled program per static [B, S], config and
    params tree: a CUDA-graph capture (:mod:`._graphs`), not ``torch.jit``,
    the counterpart of the reference's ``forward_jit``.  The ids are checked
    on the way into the graph's static buffer; the logits returned are a
    fresh copy.  Not differentiable.  On the CPU it runs :func:`forward`."""
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens)
    check_token_ids(tokens, config)
    out = _graphs.run(programs, "forward", lambda t: forward(params, t, config),
                      device=device, static=(config,), inputs=(tokens,),
                      bound=params)
    return out.clone() if _graphs.graphed(device) else out


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
    cannot take."""
    from tputopo_torch.sharding import active_plan, kv_replicated

    plan = active_plan()
    if plan is None:
        return None
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
