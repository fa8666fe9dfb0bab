"""Multi-head latent attention (MLA), DeepSeek-V2/V3's attention, over the
serving path's latent cache.

The layer (DeepSeek-V2, arXiv:2405.04434 §2.1; DeepSeek-V3,
arXiv:2412.19437 §2.1), per token with hidden state ``h``:

- queries through a low-rank pair: ``c_q = RMSNorm(h W_qa)`` (``q_a``,
  ``q_a_norm``, rank ``q_rank``), then ``q = c_q W_qb`` (``q_b``), each
  head's ``nope`` features and its ``rope`` features, the latter rotated;
- the keys' and values' shared latent: ``h W_kva`` (``kv_a``) gives
  ``c_kv`` (rank ``kv_rank``), normed by ``kv_a_norm``, and one ``k_pe``
  of ``rope`` features shared by every head, rotated;
- each head's key ``[c_kv W_uk, k_pe]`` and value ``c_kv W_uv``, where
  ``kv_b`` holds ``W_uk`` and ``W_uv`` side by side per head;
- softmax(q·k × scale) over the causal positions, the values, and ``wo``.

The cache keeps a token's row ``[c_kv, k_pe]`` (``kv_rank + rope`` wide,
:class:`~.decode.KVCache`'s ``latent``), not its heads' keys and values.
:func:`~.attention.cached_latent_attention` attends it in the absorbed form
for a few queries a row and in the up-projected form for prefill chunks.

RoPE is YaRN's (arXiv:2309.00071, as DeepSeek's ``rope_scaling``): each
frequency blends the original one and one ``factor`` times slower by a
linear ramp between the dims that turn ``beta_fast`` and ``beta_slow``
times over ``original`` positions, and the tables are scaled by
mscale(factor, mscale) / mscale(factor, mscale_all_dim).  DeepSeek's rope
features rotate in adjacent (even, odd) pairs, not in halves as the Llama
blocks of :mod:`.model` do.  The softmax scale is (nope + rope)^-1/2 times
mscale(factor, mscale_all_dim)^2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tputopo_torch.model import _rmsnorm
from tputopo_torch.quant import qdot


@dataclass(frozen=True)
class MLAConfig:
    """Latent attention's widths and RoPE (attached to ``ModelConfig.mla``;
    the model's ``n_heads`` and ``rope_theta`` are its heads and base)."""

    q_rank: int = 32
    kv_rank: int = 16
    nope: int = 8
    rope: int = 4
    v: int = 8
    # YaRN; factor 1 is plain RoPE at the model's theta
    factor: float = 1.0
    original: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0

    @property
    def row(self) -> int:
        """A cache row's width: ``c_kv`` and ``k_pe``."""
        return self.kv_rank + self.rope

    @staticmethod
    def deepseek_v3() -> "MLAConfig":
        return MLAConfig(q_rank=1536, kv_rank=512, nope=128, rope=64, v=128,
                         factor=40.0, original=4096, beta_fast=32.0, beta_slow=1.0,
                         mscale=1.0, mscale_all_dim=1.0)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature term: 0.1 mscale ln(factor) + 1 (1 at
    factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_ramp(m: MLAConfig, theta: float) -> tuple[float, float]:
    """(low, high): the rope dims between which YaRN's ramp runs, the dims
    whose wavelength turns ``beta_fast`` and ``beta_slow`` times over the
    original context, floored and ceiled, clamped into [0, rope - 1]."""
    def dim(turns):
        return (m.rope * math.log(m.original / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    return (max(math.floor(dim(m.beta_fast)), 0),
            min(math.ceil(dim(m.beta_slow)), m.rope - 1))


def softmax_scale(m: MLAConfig) -> float:
    s = yarn_mscale(m.factor, m.mscale_all_dim)
    return (m.nope + m.rope) ** -0.5 * s * s


def rope_tables(m: MLAConfig, theta: float, seq: int, device) -> tuple:
    """(cos, sin), each [seq, rope / 2] f32: YaRN's frequencies at positions
    0..seq-1.  theta stays a 0-dim CPU tensor (a kernel argument, as
    :func:`~.model._rope_tables` keeps it), so a capture records the
    tables' kernels."""
    half = m.rope // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    base = torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    if m.factor > 1:
        low, high = yarn_ramp(m, theta)
        ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
                / max(high - low, 1e-3)).clamp(0, 1)
        # dims below the ramp keep their frequency, dims above it slow down
        # by the factor
        base = base / m.factor * ramp + base * (1 - ramp)
    angles = (torch.arange(seq, dtype=torch.float32, device=device)[:, None]
              * base[None, :])
    scale = yarn_mscale(m.factor, m.mscale) / yarn_mscale(m.factor, m.mscale_all_dim)
    return torch.cos(angles) * scale, torch.sin(angles) * scale


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, N, rope] rotated in adjacent (even, odd) feature pairs, pair
    i by the angle of frequency i; cos/sin [T, rope/2] or [B, T, rope/2]."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).flatten(-2).to(dt)


def queries(h: torch.Tensor, layer: dict, config, cos, sin) -> tuple:
    """h [B, T, D] normed -> (q_nope [B, T, N, nope], q_pe [B, T, N, rope]
    rotated), at the compute dtype."""
    m = config.mla
    B, T = h.shape[:2]
    cq = _rmsnorm(qdot(h, layer["q_a"]), layer["q_a_norm"], config.norm_eps)
    q = qdot(cq, layer["q_b"]).reshape(B, T, config.n_heads, m.nope + m.rope)
    q_nope, q_pe = q.split([m.nope, m.rope], dim=-1)
    return q_nope, rope_pairs(q_pe, cos, sin)


def latent_row(h: torch.Tensor, layer: dict, config, cos, sin) -> torch.Tensor:
    """h [B, T, D] normed -> the cache rows [B, T, kv_rank + rope]: the normed
    ``c_kv`` and the rotated ``k_pe``."""
    m = config.mla
    kv = qdot(h, layer["kv_a"])
    c, k_pe = kv.split([m.kv_rank, m.rope], dim=-1)
    c = _rmsnorm(c, layer["kv_a_norm"], config.norm_eps)
    return torch.cat([c, rope_pairs(k_pe[:, :, None], cos, sin)[:, :, 0]], dim=-1)


def init_layers(c, L: int, norm_init, dense_init) -> dict:
    """The attention leaves of ``L`` MLA layers, in draw order, for
    :func:`~.model.init_params`."""
    m, D, N = c.mla, c.d_model, c.n_heads
    return {
        "attn_norm": norm_init("attn_norm", (L, D)),
        "q_a": dense_init("q_a", (L, D, m.q_rank), D),
        "q_a_norm": norm_init("q_a_norm", (L, m.q_rank)),
        "q_b": dense_init("q_b", (L, m.q_rank, N * (m.nope + m.rope)), m.q_rank),
        "kv_a": dense_init("kv_a", (L, D, m.row), D),
        "kv_a_norm": norm_init("kv_a_norm", (L, m.kv_rank)),
        "kv_b": dense_init("kv_b", (L, m.kv_rank, N * (m.nope + m.v)), m.kv_rank),
        "wo": dense_init("wo", (L, N * m.v, D), N * m.v),
        "mlp_norm": norm_init("mlp_norm", (L, D)),
    }
