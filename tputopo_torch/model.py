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
What the port leaves out so far raises ``NotImplementedError``: MoE
layers (``moe``) and LoRA weight leaves.  The reference's
context-parallel strategies (``sp_impl``) act only under an
active multi-device mesh plan, which a single card never has; the port
keeps the field and its eager check so configs carry over.  The
reference's ``constrain`` sharding annotations are the identity on one
card and are dropped.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``); with no GPU and no such request they raise.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
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


def init_params(config: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Parameter dict in the reference's stacked layout, f32, drawn from
    a ``torch.Generator`` seeded with ``seed`` on the target device."""
    c = config
    _check_supported(c)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def norm_init(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def dense_init(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(1.0 / math.sqrt(fan_in))

    L, D, H, KV, Hd, Fd = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                           c.head_dim, c.d_ff)
    return {
        "embed": dense_init((c.vocab_size, D), D),
        "layers": {
            "attn_norm": norm_init((L, D)),
            "wq": dense_init((L, D, H * Hd), D),
            "wk": dense_init((L, D, KV * Hd), D),
            "wv": dense_init((L, D, KV * Hd), D),
            "wo": dense_init((L, H * Hd, D), H * Hd),
            "mlp_norm": norm_init((L, D)),
            "w_gate": dense_init((L, D, Fd), D),
            "w_up": dense_init((L, D, Fd), D),
            "w_down": dense_init((L, Fd, D), Fd),
        },
        "final_norm": norm_init((D,)),
        "lm_head": dense_init((D, c.vocab_size), D),
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
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    c = config
    B, S, D = x.shape
    q = qdot(x, p["wq"]).reshape(B, S, c.n_heads, c.head_dim)
    k = qdot(x, p["wk"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    v = qdot(x, p["wv"]).reshape(B, S, c.n_kv_heads, c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    group = c.n_heads // c.n_kv_heads
    if group > 1:
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
    out = out.reshape(B, S, c.n_heads * c.head_dim)
    return qdot(out, p["wo"])


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
    # The same shape rule that picks the kernel on a TPU, on a CUDA card.
    return block == 128 and shapes_ok and device.type == "cuda"


def _flash_dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention on one card.  The block sizes only carry the
    reference's shape contract; the kernel tiles on its own."""
    block = min(128, q.shape[1])
    return flash_attention(q, k, v, causal=True, block_q=block, block_kv=block)


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    gate = F.silu(qdot(x, p["w_gate"]))
    up = qdot(x, p["w_up"])
    return qdot(gate * up, p["w_down"])


def transformer_block(x: torch.Tensor, layer: dict, config: ModelConfig,
                      cos: torch.Tensor, sin: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer: (x, one layer's params) -> (x, aux loss), aux 0
    for the dense FFN."""
    c = config
    h = x + _attention(_rmsnorm(x, layer["attn_norm"], c.norm_eps), layer, c,
                       cos, sin)
    y = _mlp(_rmsnorm(h, layer["mlp_norm"], c.norm_eps), layer)
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
                cos: torch.Tensor, sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    block = transformer_block
    recording = torch.is_grad_enabled() and (x.requires_grad or any(
        torch.is_tensor(w) and w.requires_grad for w in layers.values()))
    if recording:  # remat is a memory policy of the backward pass only
        block = apply_remat(transformer_block, config.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = block(x, _layer(layers, i), config, cos, sin)
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


def lm_head(params: dict, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Final norm and head -> f32 logits.  The head is rounded to
    ``compute_dtype`` as in the reference, and the product of the two
    compute-dtype operands accumulates in f32 without rounding the logits:
    both operands are widened to f32, where bf16 products are exact.  A
    quantized head contracts the f32 activations (:func:`.quant.qdot`)."""
    x = _rmsnorm(x, params["final_norm"], config.norm_eps)
    w = params["lm_head"]
    if is_quantized(w):
        return qdot(x.float(), w)
    return x.float() @ w.to(config.compute_dtype).float()


def forward_with_aux(params: dict, tokens: torch.Tensor,
                     config: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (logits [B, S, vocab] f32, aux loss scalar), on
    the device that holds ``params``; differentiable in the parameters."""
    c = config
    _check_supported(c)
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens, device=device)
    cos, sin = _rope_tables(c, tokens.shape[1], device)
    x = embed_tokens(params, tokens, c)
    x, aux = _block_loop(x, params["layers"], c, cos, sin)
    return lm_head(params, x, c), aux


def forward(params: dict, tokens: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, vocab] (float32)."""
    return forward_with_aux(params, tokens, config)[0]
