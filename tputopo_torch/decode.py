"""Autoregressive decoding with a KV cache — the counterpart of
``tputopo/workloads/decode.py``, the one-shot path that answers requests
(fixed batch, uniform prompts, run to completion).

The cache is a pair of preallocated ``[L, B, S_max, KV, H]`` buffers in
``compute_dtype``, or, with ``kv_dtype="int8"``, int8 buffers beside
float32 scale buffers ``[L, B, S_max, KV, 1]``; an MLA config's is one
latent buffer ``[L, B, S_max, kv_rank + rope]`` (:mod:`.mla`).  Where JAX threads a new
cache value through ``lax.scan``, this module writes the new K/V rows into
the buffers in place (:func:`_write_kv_at`, quantizing them for an int8
cache) and loops over layers and steps in Python.

:func:`cached_layers` is the one layer stack over a cache, for this
module's one-shot blocks (every row at one start) and for the serving
engine's ragged steps (each slot at its own start).  The prompt fills the
cache in one batched :func:`_block_step`, then each new token is one
single-position step.  Attention over the cache is
:func:`~.attention.cached_attention`: the grouped GQA einsum of the
reference, in f32 with ``-1e30`` masking, or on the card, for a bf16 cache,
the decode-attention kernel for few queries a row and the chunk-attention
kernel for the prefill's wider blocks.  The prefill does not go through the
flash kernel, whose causal mask starts every query at position 0.

Decoding policies: greedy (temperature 0, the default) and temperature
sampling with optional top-k, drawn from a caller's ``torch.Generator``.
:func:`generate_jit`, the reference's compiled ``generate``, is one
CUDA-graph capture of the whole loop (:mod:`._graphs`).
The FFN of an MoE config is the drop-free mixture, the reference's
serving semantics (the capacity-dispatch training path would drop tokens
during a prefill): on CUDA with raw expert tables and bfloat16 compute the
routed layer (:func:`~.moe.moe_mlp_routed`, grouped GEMMs over the routed
pairs), otherwise the loop over the experts
(:func:`~.moe.moe_mlp_reference`: quantized tables, the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tputopo_torch import _graphs
from tputopo_torch.attention import cached_attention, cached_latent_attention
from tputopo_torch.model import (ModelConfig, _apply_rope, _check_supported,
                                 _rmsnorm, _rope_tables, check_token_ids,
                                 embed_tokens, layer_at, lm_head, n_dense,
                                 resolve_device)
from tputopo_torch.quant import deq_rows, qdot, quantize_kv


class KVCache(NamedTuple):
    k: torch.Tensor | None  # [L, B, S_max, KV, H]  compute_dtype, or int8
    v: torch.Tensor | None  # [L, B, S_max, KV, H]
    # int8 cache only: per-(batch, position, kv-head) absmax scales,
    # [L, B, S_max, KV, 1] f32.  None for a bf16 cache.
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    # An MoE config's expert choices, kept where asked for: the top-k expert
    # ids [L_moe, B, S_max, k] int16 (ids up to 32767) of the token at each
    # position in each expert layer, written beside its K/V by the serving
    # bodies (-1 where none was).
    routes: torch.Tensor | None = None
    # An MLA config's cache, in place of k and v: each token's normed c_kv
    # and rotated k_pe, [L, B, S_max, kv_rank + rope] at compute_dtype.
    latent: torch.Tensor | None = None

    @property
    def positions(self) -> int:
        """S_max, the positions a row holds."""
        return (self.k if self.latent is None else self.latent).shape[2]

    @staticmethod
    def create(config: ModelConfig, batch: int, max_len: int, *,
               device=None, routes: bool = False) -> "KVCache":
        """Zeroed buffers; with ``routes`` (an MoE config), the expert ids'
        buffer too."""
        c = config
        if c.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {c.kv_dtype!r}")
        if routes and c.moe is None:
            raise ValueError("routes are kept for an MoE config only")
        dev = resolve_device(device)
        picks = (torch.full((c.n_layers - n_dense(c), batch, max_len, c.moe.top_k), -1,
                            dtype=torch.int16, device=dev) if routes else None)
        if c.mla is not None:
            if c.kv_dtype != "bf16":
                raise ValueError("the int8 KV cache has no latent (MLA) layout")
            return KVCache(k=None, v=None, routes=picks, latent=torch.zeros(
                (c.n_layers, batch, max_len, c.mla.row), dtype=c.compute_dtype,
                device=dev))
        shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
        if c.kv_dtype == "int8":
            sshape = shape[:-1] + (1,)
            return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                           v=torch.zeros(shape, dtype=torch.int8, device=dev),
                           k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                           v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                           routes=picks)
        return KVCache(k=torch.zeros(shape, dtype=c.compute_dtype, device=dev),
                       v=torch.zeros(shape, dtype=c.compute_dtype, device=dev),
                       routes=picks)


def _window_start(start: torch.Tensor, size: int, width: int) -> torch.Tensor:
    """Where ``dynamic_slice`` / ``dynamic_update_slice`` put a ``width``
    window at ``start`` in an axis of ``size``: a negative start counts
    once from the end, then clamps into [0, size - width]."""
    return torch.where(start < 0, start + size, start).clamp(0, size - width)


def _write_kv_at(cache_l: torch.Tensor, kv: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Per-row T-wide cache write, in place and as one indexed write:
    cache_l [B, S, ...] <- kv [B, T, ...] at positions pos[b]..pos[b]+T-1.
    Like the reference's ``dynamic_update_slice``, a negative start counts
    once from the end, and a start is then clamped into [0, S - T], so a
    window that would run past the buffer's end overwrites EARLIER rows:
    callers keep pos[b] + T <= S for windows that matter (see
    :func:`~.serving.ragged_block`)."""
    B, T = kv.shape[:2]
    idx = _window_start(pos, cache_l.shape[1], T)[:, None] + torch.arange(
        T, device=pos.device)
    cache_l[torch.arange(B, device=pos.device)[:, None], idx] = kv


def cached_layers(params: dict, config: ModelConfig, x: torch.Tensor,
                  cos_bt: torch.Tensor, sin_bt: torch.Tensor, starts: torch.Tensor,
                  cache: KVCache, span: int | None = None) -> torch.Tensor:
    """The layer stack over a KV cache: embedded rows x [B, T, D] whose
    RoPE rows cos_bt/sin_bt ([B, T, H/2], or [T, H/2] shared by every row)
    are given, row b's K/V (and, where the cache keeps them, its expert
    choices) written at its window ``starts[b]`` and its queries masked
    from its raw start -> the last layer's output [B, T, D].  One start for
    every row is the one-shot block (:func:`_block_hidden`); one per slot
    is the serving step (:func:`~.serving.ragged_hidden`).  An MLA config
    writes each token's latent row and attends the latent cache
    (:func:`~.attention.cached_latent_attention`), only the rows below
    ``span`` where the caller knows that no query attends past it."""
    c = config
    B, T = x.shape[:2]
    K = n_dense(c)
    for i in range(c.n_layers):
        layer = layer_at(params["layers"], c, i)
        h = _rmsnorm(x, layer["attn_norm"], c.norm_eps)
        if c.mla is not None:
            x = x + _latent_attention(h, layer, c, cos_bt, sin_bt, starts,
                                      cache.latent[i], span)
        else:
            x = x + _gqa_attention(h, layer, c, cos_bt, sin_bt, starts, cache, i)
        h = _rmsnorm(x, layer["mlp_norm"], c.norm_eps)
        if cache.routes is None or i < K:
            x = x + serving_ffn(h, layer, c)
        else:  # the expert choices kept beside the K/V rows
            y, picks = serving_ffn(h, layer, c, picks=True)
            _write_kv_at(cache.routes[i - K], picks.to(cache.routes.dtype), starts)
            x = x + y
    return x


def _gqa_attention(h, layer, c, cos_bt, sin_bt, starts, cache, i) -> torch.Tensor:
    """Layer ``i``'s grouped-query attention over the K/V cache: its K/V rows
    written at ``starts`` -> the output projection [B, T, D]."""
    B, T = h.shape[:2]
    q = qdot(h, layer["wq"]).reshape(B, T, c.n_heads, c.head_dim)
    k = qdot(h, layer["wk"]).reshape(B, T, c.n_kv_heads, c.head_dim)
    v = qdot(h, layer["wv"]).reshape(B, T, c.n_kv_heads, c.head_dim)
    q = _apply_rope(q, cos_bt, sin_bt)
    k = _apply_rope(k, cos_bt, sin_bt)
    cks = cvs = None
    if cache.k_scale is not None:
        cks, cvs = cache.k_scale[i], cache.v_scale[i]
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        _write_kv_at(cks, ks, starts)
        _write_kv_at(cvs, vs, starts)
    _write_kv_at(cache.k[i], k, starts)
    _write_kv_at(cache.v[i], v, starts)
    out = cached_attention(q, cache.k[i], cache.v[i], starts, c.n_heads // c.n_kv_heads,
                           cks, cvs)
    return qdot(out.reshape(B, T, c.n_heads * c.head_dim), layer["wo"])


def _latent_attention(h, layer, c, cos_bt, sin_bt, starts, latent, span) -> torch.Tensor:
    """One MLA layer over the latent cache (:mod:`.mla`): the tokens' latent
    rows written at ``starts`` -> the output projection [B, T, D]."""
    from tputopo_torch import mla

    B, T = h.shape[:2]
    q_nope, q_pe = mla.queries(h, layer, c, cos_bt, sin_bt)
    _write_kv_at(latent, mla.latent_row(h, layer, c, cos_bt, sin_bt), starts)
    out = cached_latent_attention(q_nope, q_pe, latent, starts, layer["kv_b"], c.mla, span)
    return qdot(out.reshape(B, T, c.n_heads * c.mla.v), layer["wo"])


def _block_step(params: dict, config: ModelConfig, tokens: torch.Tensor,
                start: int, cache: KVCache, cos: torch.Tensor,
                sin: torch.Tensor, *, check_ids: bool = True) -> torch.Tensor:
    """Feed ``tokens`` [B, T] at positions start..start+T-1 through the
    stack, writing their K/V into ``cache`` -> logits [B, T, V].  T equal
    to the prompt length is the prefill; T == 1 is one decode step."""
    return lm_head(params, _block_hidden(params, config, tokens, start, cache,
                                         cos, sin, check_ids=check_ids), config)


def _block_hidden(params: dict, config: ModelConfig, tokens: torch.Tensor,
                  start: int, cache: KVCache, cos: torch.Tensor,
                  sin: torch.Tensor, *, check_ids: bool = True) -> torch.Tensor:
    """:func:`_block_step` without the head: the last layer's output
    [B, T, D], before the final norm.  Callers that need the logits of few
    positions, or none (a prefill chunk), skip the head's work on the
    rest, as XLA drops it from the reference's programs that discard it.
    ``check_ids=False`` skips the id range check, a readback, for ids the
    model picked itself (the speculative loop's blocks)."""
    B, T = tokens.shape
    x = (embed_tokens(params, tokens, config) if check_ids  # [B, T, D]
         else deq_rows(params["embed"], tokens, config.compute_dtype))
    starts = torch.full((B,), start, dtype=torch.long, device=tokens.device)
    return cached_layers(params, config, x, cos[start:start + T],
                         sin[start:start + T], starts, cache)


def serving_ffn(h: torch.Tensor, layer: dict, config: ModelConfig, *,
                picks: bool = False):
    """One layer's FFN on the serving paths: the dense SwiGLU, or the
    drop-free expert mixture of an MoE layer, by the routed layer where
    :func:`~.moe.routed_takes` it and by the loop over the experts
    elsewhere.  With ``picks`` (MoE only), (output, the top-k expert ids
    [B, T, k])."""
    if "moe" in layer:
        from tputopo_torch import moe

        if moe.routed_takes(h, layer["moe"], config):
            return moe.moe_mlp_routed(h, layer["moe"], config, picks=picks)
        return moe.moe_mlp_reference(h, layer["moe"], config, picks=picks)
    gate = F.silu(qdot(h, layer["w_gate"]))
    return qdot(gate * qdot(h, layer["w_up"]), layer["w_down"])


def _select(logits: torch.Tensor, temperature: float, top_k: int | None,
            generator: torch.Generator | None) -> torch.Tensor:
    """Next token from [B, V] logits: argmax at temperature 0, otherwise
    a draw from the (optionally top-k-truncated) tempered distribution."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits / temperature
    if top_k is not None:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    # torch.multinomial's one-sample draw written out (the argmax of p / E,
    # E ~ Exp(1)): its argument check reads the probabilities back, which
    # a CUDA graph cannot record.  E is kept above 0, so a token of
    # probability 0 is never drawn.
    e = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / e.clamp_min_(torch.finfo(e.dtype).tiny)).argmax(dim=-1)


def _generate_limits(config: ModelConfig, P: int, max_new: int,
                     max_len: int | None, temperature: float,
                     generator: torch.Generator | None) -> int:
    """Validate a generate call; returns the cache length."""
    _check_supported(config)
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    total = P + max_new
    max_len = max_len or total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt {P} + new {max_new}")
    return max_len


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, config: ModelConfig, *,
             max_new: int, max_len: int | None = None,
             temperature: float = 0.0, top_k: int | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Decode: prompt [B, P] -> [B, P + max_new] token ids, on the device
    that holds ``params``.

    ``temperature`` 0 (default) is greedy; above 0 it samples, optionally
    from the ``top_k`` most likely tokens, drawing from ``generator``
    (required then, on the params' device)."""
    prompt = torch.as_tensor(prompt, device=params["final_norm"].device)
    max_len = _generate_limits(config, prompt.shape[1], max_new, max_len,
                               temperature, generator)
    return _generate(params, prompt, config, max_new, max_len, temperature,
                     top_k, generator)


@torch.no_grad()
def generate_jit(params: dict, prompt: torch.Tensor, config: ModelConfig, *,
                 max_new: int, max_len: int | None = None,
                 temperature: float = 0.0, top_k: int | None = None,
                 generator: torch.Generator | None = None,
                 programs=None) -> torch.Tensor:
    """:func:`generate` as ONE compiled program per static (B, P, max_new,
    max_len, temperature, top_k) and params tree, the reference's
    ``generate_jit``: a CUDA-graph capture of the prefill and every decode
    step (:mod:`._graphs`), not ``torch.jit``, with the decode positions
    fixed at capture.  The prompt is checked on its way into the graph's
    static buffer; the tokens returned are a fresh copy.  On the CPU it
    runs :func:`generate`'s body."""
    device = params["final_norm"].device
    prompt = torch.as_tensor(prompt)
    max_len = _generate_limits(config, prompt.shape[1], max_new, max_len,
                               temperature, generator)
    check_token_ids(prompt, config)
    out = _graphs.run(programs, "generate",
                      lambda p: _generate(params, p.to(device), config, max_new,
                                          max_len, temperature, top_k, generator),
                      device=device,
                      static=(config, max_new, max_len, temperature, top_k),
                      inputs=(prompt,), bound=params, generator=generator)
    return out.clone() if _graphs.graphed(device) else out


def _generate(params: dict, prompt: torch.Tensor, config: ModelConfig,
              max_new: int, max_len: int, temperature: float, top_k: int | None,
              generator: torch.Generator | None) -> torch.Tensor:
    """The body of :func:`generate` and :func:`generate_jit`: the prompt's
    prefill, then ``max_new - 1`` single-token steps at positions P + i."""
    c = config
    device = prompt.device
    B, P = prompt.shape
    cos, sin = _rope_tables(c, max_len, device)
    cache = KVCache.create(c, B, max_len, device=device)

    logits = _block_step(params, c, prompt, 0, cache, cos, sin)
    toks = [_select(logits[:, -1], temperature, top_k, generator)]
    for i in range(max_new - 1):
        lg = _block_step(params, c, toks[-1][:, None], P + i, cache, cos, sin)
        toks.append(_select(lg[:, -1], temperature, top_k, generator))
    return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)], dim=1)
