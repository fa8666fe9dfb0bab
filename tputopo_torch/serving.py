"""Continuous-batching serving — the counterpart of
``tputopo/workloads/serving.py``: slot-based decode state, ragged prompts,
EOS early exit, mid-stream admission, bucketed and chunked prefill,
prefix caching and token streaming.

- A :class:`DecodeState` holds SLOTS, not requests: a [slots, max_len]
  token buffer, one KV cache and per-slot ``length`` / ``prompt_len`` /
  ``budget`` / ``seq_id`` / ``done`` vectors, all on the device.  Where the
  reference threads a new state value through each jitted program, the
  functions here write the state in place: admission prefills one slot
  through a view of its cache slice (``cache.k[:, slot:slot + 1]``), so no
  merge copy follows, and a decode step rewrites the per-slot vectors with
  masked updates.
- Admission pads a prompt to the smallest ``prompt_pad`` bucket covering
  it and runs the block prefill on the slot: the layer stack over the
  cache (:func:`.decode.cached_layers`) on its rows.
  Pad positions are harmless: causal masking keeps real positions from
  attending them, the first token reads the logits at ``prompt_len - 1``,
  and per-slot length masks keep them unreachable until decode writes
  overwrite them.
- The decode step is RAGGED: each slot sits at its own position, so RoPE
  rows are gathered per slot, the cache write is one indexed write over
  [slots, T] positions, and the attention mask compares with each slot's
  own position.  Idle slots (done, empty or mid-prefill) ride along
  masked, and their junk K/V goes to position max_len-1, which no query
  reaches before the step whose real write overwrites it.  The redirect is
  load-bearing for chunked prefill: a junk write at position 0 would
  clobber the first chunk of a slot that is still prefilling.
- Chunked prefill (``prefill_chunk=N``) runs a wide bucket one N-token
  chunk per engine tick, the other slots decoding between the chunks; the
  chunk holding the prompt's last token activates the slot, later chunks
  are skipped.

Every device function has its compiled counterpart under the reference's
name (``admit_jit``, ``decode_steps_jit``, ...): a CUDA-graph capture
(:mod:`._graphs`) that the engine replays.  The admissions read the slot,
start and request's ints from one device vector, as the reference's
programs take traced scalars, so one graph per width serves every slot.

The host-side :class:`ServingEngine` keeps the queue and the slot
bookkeeping.  It reads the device state back where the reference does,
once per tick (free slots, finished slots, any slot active, streaming);
nothing inside :func:`decode_step` or :func:`decode_steps` waits for the
device.  Sampling draws from a caller's ``torch.Generator`` on the
parameters' device, as :func:`.decode.generate` does: the reference's
``fold_in(key, step)`` stream cannot be reproduced draw for draw, so the
state keeps no step counter.  The reference's sharding constraints are
the identity on one card and are dropped.  An MoE config's FFN is the
drop-free mixture, as in :mod:`.decode`: on CUDA with raw expert tables the
routed layer (:func:`~.moe.moe_mlp_routed`), whose sort, grouped GEMMs and
combine replay inside the programs' graphs; with quantized tables or on
the CPU the loop over the experts.  An MLA config (DeepSeek-V3) keeps the
latent cache (``KVCache.latent``), gathered and written back per slot as
the K/V buffers are, and runs the same programs over it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tputopo_torch import _graphs, _kernels, attention, moe, obs
from tputopo_torch.decode import (KVCache, _block_hidden, _select, _window_start,
                                  cached_layers)
from tputopo_torch.model import (ModelConfig, _check_supported, _rope_tables,
                                 check_token_ids, embed_tokens, lm_head,
                                 resolve_device)
from tputopo_torch.quant import compute_bytes, compute_params, deq_rows


class DecodeState(NamedTuple):
    """Slot-based serving state — the whole engine's device residency."""

    cache: KVCache          # k/v [L, slots, max_len, KV, H]
    tokens: torch.Tensor    # [slots, max_len] int64 (prompt + generated)
    length: torch.Tensor    # [slots] int64: tokens held; next write position
    prompt_len: torch.Tensor  # [slots] int64
    budget: torch.Tensor    # [slots] int64: max tokens to generate
    seq_id: torch.Tensor    # [slots] int64: request id, -1 == empty
    done: torch.Tensor      # [slots] bool: finished, awaiting harvest

    @property
    def active(self) -> torch.Tensor:
        return (self.seq_id >= 0) & ~self.done


def init_state(config: ModelConfig, slots: int, max_len: int, *,
               device=None, record_routes: bool = False) -> DecodeState:
    """An empty state on ``device`` (``cuda`` unless the caller asks for
    the CPU); with ``record_routes`` (an MoE config), its cache keeps the
    expert choices at every position (``KVCache.routes``)."""
    _check_supported(config)
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.long, device=dev)

    return DecodeState(
        cache=KVCache.create(config, slots, max_len, device=dev, routes=record_routes),
        tokens=zeros(slots, max_len), length=zeros(slots),
        prompt_len=zeros(slots), budget=zeros(slots),
        seq_id=torch.full((slots,), -1, dtype=torch.long, device=dev),
        done=torch.zeros(slots, dtype=torch.bool, device=dev))


# ---- admission: ragged prefill into one slot --------------------------------
#
# The admission programs read their scalars from one int64 device vector, as
# the reference's programs take traced scalars: one body, and one captured
# graph per (program, width), serves every slot, offset and request.
_SLOT, _START, _PLEN, _SEQ, _BUDGET, _EOS = range(6)


def _scalars(state: DecodeState, slot: int, start: int = 0, prompt_len: int = 0,
             seq_id: int = 0, budget: int = 0, eos_id: int = 0) -> torch.Tensor:
    """The admission scalars as a host int64 vector.  ``slot`` must lie in
    range: the reference clamps it, a device gather would fault."""
    if not 0 <= slot < state.tokens.shape[0]:
        raise ValueError(f"slot {slot} outside [0, {state.tokens.shape[0]})")
    return torch.tensor([slot, start, prompt_len, seq_id, budget, eos_id],
                        dtype=torch.long)


def _slot_cache(cache: KVCache, slot: int) -> KVCache:
    """One slot's cache slice as a batch-1 cache: views, so a block
    prefill writes the slot in place.  Every buffer, the int8 scales
    included, shares the [L, slots, ...] layout."""
    return KVCache(*(None if b is None else b[:, slot:slot + 1] for b in cache))


def _slot_prefill(params: dict, whole: KVCache, config: ModelConfig,
                  slot: torch.Tensor, tokens: torch.Tensor,
                  start: torch.Tensor, span: int | None = None) -> torch.Tensor:
    """``tokens`` [T] at positions start..start+T-1 through the stack
    against the rows of ``slot`` (a [1] device index) of the cache
    ``whole``, which are gathered and written back, as the reference runs
    its ``_block_step`` on the slot's cache and merges that back -> the
    last layer's output [1, T, D].  ``start`` ([1]) places the
    window as ``dynamic_slice`` does (:func:`_window_start`) for the RoPE
    rows and the cache write; the causal mask compares with the raw start,
    as the reference's does.  ``span`` as :func:`~.decode.cached_layers`
    takes it."""
    S, T = whole.positions, tokens.shape[0]
    cache = KVCache(*(None if b is None else b.index_select(1, slot)
                      for b in whole))
    cos, sin = _rope_tables(config, S, tokens.device)
    rows = _window_start(start, S, T)[:, None] + torch.arange(T, device=tokens.device)
    x = embed_tokens(params, tokens[None, :], config)
    x = cached_layers(params, config, x, cos[rows], sin[rows], start, cache, span=span)
    for buf, b in zip(whole, cache):
        if b is not None:
            buf.index_copy_(1, slot, b)
    return x


def _finish_admit(state: DecodeState, slot: torch.Tensor, first: torch.Tensor,
                  prompt_row: torch.Tensor, prompt_len: torch.Tensor,
                  seq_id: torch.Tensor, budget: torch.Tensor,
                  eos_id: torch.Tensor) -> None:
    """Shared tail of whole-bucket and chunked admission, every argument a
    [1] device tensor but ``prompt_row`` (bucket-length or max_len):
    install the token row (prompt, zeros past it, then the first token)
    and activate the slot."""
    max_len = state.tokens.shape[1]
    w = min(prompt_row.shape[0], max_len)
    pos = torch.arange(max_len, device=first.device)
    row = torch.zeros(max_len, dtype=state.tokens.dtype, device=first.device)
    row[:w] = prompt_row[:w]
    row = torch.where(pos < prompt_len, row, 0)
    row = torch.where(pos == prompt_len, first, row)  # the reference's mode="drop"
    length = prompt_len + 1
    state.tokens.index_copy_(0, slot, row[None, :])
    state.length.index_copy_(0, slot, length)
    state.prompt_len.index_copy_(0, slot, prompt_len)
    state.budget.index_copy_(0, slot, budget)
    state.seq_id.index_copy_(0, slot, seq_id)
    # Done at once when the first token is EOS, the budget was one token,
    # or the buffer is full.
    state.done.index_copy_(0, slot, (first == eos_id) | (budget <= 1)
                           | (length >= max_len))


def _admission(params: dict, state: DecodeState, config: ModelConfig,
               chunk: torch.Tensor, a: torch.Tensor, prompt: torch.Tensor | None,
               temperature: float, top_k: int | None,
               generator: torch.Generator | None, span: int | None = None) -> None:
    """The one body of the admission programs, in place: ``chunk`` into the
    slot's cache at the start ``a`` names; with ``prompt`` (the padded
    row), also the first token, picked from the logits at prompt_len - 1
    (an index into the chunk placed as ``dynamic_index_in_dim`` places
    it), and the slot's activation."""
    slot, start = a[_SLOT:_SLOT + 1], a[_START:_START + 1]
    x = _slot_prefill(params, state.cache, config, slot, chunk, start, span)
    if prompt is None:
        return
    plen = a[_PLEN:_PLEN + 1]
    last = _window_start(plen - 1 - start, chunk.shape[0], 1)
    first = _select(lm_head(params, x[0].index_select(0, last), config),
                    temperature, top_k, generator)
    _finish_admit(state, slot, first, prompt, plen, a[_SEQ:_SEQ + 1],
                  a[_BUDGET:_BUDGET + 1], a[_EOS:_EOS + 1])


def _admit_program(programs, name: str, params: dict, state: DecodeState,
                   config: ModelConfig, chunk, a: torch.Tensor, prompt=None, *,
                   temperature: float = 0.0, top_k: int | None = None,
                   generator: torch.Generator | None = None, jit: bool) -> None:
    """Run :func:`_admission`: eagerly, or as the compiled program ``name``
    (one graph per config, chunk and prompt width, temperature and top_k,
    and for an MLA config per chunk end, ``span``: latent attention reads
    the slot's rows below it only, :func:`~.attention.cached_latent_attention`).
    Host ids are range-checked here, where they enter the device."""
    device = state.tokens.device
    inputs = (torch.as_tensor(chunk), a) + (() if prompt is None
                                            else (torch.as_tensor(prompt),))
    span = (None if config.mla is None
            else min(int(a[_START]) + inputs[0].shape[0], state.cache.positions))

    def body(chunk, a, prompt=None):
        _admission(params, state, config, chunk, a, prompt, temperature, top_k,
                   generator, span)

    if not jit:
        return body(*(t.to(device) for t in inputs))
    check_token_ids(inputs[0], config)
    static = (config, temperature, top_k) + (() if span is None else (span,))
    _graphs.run(programs, name, body, device=device, static=static, inputs=inputs,
                bound=(params, state), mutated=state, generator=generator)


@torch.no_grad()
def admit(params: dict, state: DecodeState, config: ModelConfig, slot: int,
          prompt: torch.Tensor, prompt_len: int, seq_id: int, budget: int,
          eos_id: int, *, temperature: float = 0.0, top_k: int | None = None,
          generator: torch.Generator | None = None) -> None:
    """Prefill ``prompt`` (padded to its bucket length) into ``slot`` and
    emit its first token, in place.  ``eos_id`` < 0 disables EOS."""
    _admit_program(None, "admit", params, state, config, prompt,
                   _scalars(state, slot, 0, prompt_len, seq_id, budget, eos_id),
                   prompt, temperature=temperature, top_k=top_k,
                   generator=generator, jit=False)


@torch.no_grad()
def admit_jit(params: dict, state: DecodeState, config: ModelConfig, slot: int,
              prompt: torch.Tensor, prompt_len: int, seq_id: int, budget: int,
              eos_id: int, *, temperature: float = 0.0, top_k: int | None = None,
              generator: torch.Generator | None = None, programs=None) -> None:
    """:func:`admit` as one compiled program per bucket width: a CUDA-graph
    capture (:mod:`._graphs`), not ``torch.jit``.  The slot and the ints
    reach the graph as device scalars, so every slot and request replays
    it.  On the CPU it runs :func:`admit`'s body."""
    _admit_program(programs, "admit", params, state, config, prompt,
                   _scalars(state, slot, 0, prompt_len, seq_id, budget, eos_id),
                   prompt, temperature=temperature, top_k=top_k,
                   generator=generator, jit=True)


@torch.no_grad()
def prefill_chunk(params: dict, state: DecodeState, config: ModelConfig,
                  slot: int, chunk: torch.Tensor, start: int) -> None:
    """One NON-final chunk of a chunked prefill: ``chunk`` at positions
    start.. fills only the slot's cache, and the slot stays inactive, so
    other slots decode between chunks.  Causally exact: the chunk attends
    itself plus the chunks already in the cache."""
    _admit_program(None, "prefill_chunk", params, state, config, chunk,
                   _scalars(state, slot, start), jit=False)


@torch.no_grad()
def prefill_chunk_jit(params: dict, state: DecodeState, config: ModelConfig,
                      slot: int, chunk: torch.Tensor, start: int, *,
                      programs=None) -> None:
    """:func:`prefill_chunk` as one compiled program per chunk width, a
    CUDA-graph capture (:mod:`._graphs`), not ``torch.jit``; the slot and
    start are device scalars."""
    _admit_program(programs, "prefill_chunk", params, state, config, chunk,
                   _scalars(state, slot, start), jit=True)


@torch.no_grad()
def admit_final_chunk(params: dict, state: DecodeState, config: ModelConfig,
                      slot: int, prompt: torch.Tensor, chunk: torch.Tensor,
                      start: int, prompt_len: int, seq_id: int, budget: int,
                      eos_id: int, *, temperature: float = 0.0,
                      top_k: int | None = None,
                      generator: torch.Generator | None = None) -> None:
    """The FINAL chunk of a chunked prefill: position prompt_len-1 lies in
    ``chunk``, so this fills its cache span and activates the slot (first
    token, and the token row from the full padded ``prompt``)."""
    _admit_program(None, "admit_final_chunk", params, state, config, chunk,
                   _scalars(state, slot, start, prompt_len, seq_id, budget, eos_id),
                   prompt, temperature=temperature, top_k=top_k,
                   generator=generator, jit=False)


@torch.no_grad()
def admit_final_chunk_jit(params: dict, state: DecodeState, config: ModelConfig,
                          slot: int, prompt: torch.Tensor, chunk: torch.Tensor,
                          start: int, prompt_len: int, seq_id: int, budget: int,
                          eos_id: int, *, temperature: float = 0.0,
                          top_k: int | None = None,
                          generator: torch.Generator | None = None,
                          programs=None) -> None:
    """:func:`admit_final_chunk` as one compiled program per chunk width
    and prompt row width, a CUDA-graph capture (:mod:`._graphs`), not
    ``torch.jit``: the engine passes max_len rows, so a prefix of any
    length replays it."""
    _admit_program(programs, "admit_final_chunk", params, state, config, chunk,
                   _scalars(state, slot, start, prompt_len, seq_id, budget, eos_id),
                   prompt, temperature=temperature, top_k=top_k,
                   generator=generator, jit=True)


# ---- prefix caching: compute a shared prompt prefix's KV once ---------------

@torch.no_grad()
def build_prefix_cache(params: dict, config: ModelConfig,
                       tokens: torch.Tensor) -> KVCache:
    """KV for a shared prefix [P], computed once into a batch-1, length-P
    cache on the parameters' device.  RoPE is absolute, so these rows equal
    computing the prefix in place at positions 0..P-1 of any slot."""
    tokens = torch.as_tensor(tokens, device=params["final_norm"].device)
    P = tokens.shape[0]
    cos, sin = _rope_tables(config, P, tokens.device)
    cache = KVCache.create(config, 1, P, device=tokens.device)
    _block_hidden(params, config, tokens[None, :], 0, cache, cos, sin)
    return cache


@torch.no_grad()
def build_prefix_cache_jit(params: dict, config: ModelConfig,
                           tokens: torch.Tensor, *, programs=None) -> KVCache:
    """:func:`build_prefix_cache` as one compiled program per prefix
    length, a CUDA-graph capture (:mod:`._graphs`), not ``torch.jit``; the
    cache returned is a fresh copy."""
    device = params["final_norm"].device
    tokens = torch.as_tensor(tokens)
    check_token_ids(tokens, config)
    out = _graphs.run(programs, "build_prefix_cache",
                      lambda t: build_prefix_cache(params, config, t),
                      device=device, static=(config,), inputs=(tokens,),
                      bound=params)
    if not _graphs.graphed(device):
        return out
    return KVCache(*(None if b is None else b.clone() for b in out))


def _copy_prefix(state: DecodeState, prefix: KVCache, slot: torch.Tensor) -> None:
    for whole, b in zip(state.cache, prefix):
        if b is not None:
            whole.narrow(2, 0, b.shape[2]).index_copy_(1, slot, b)


@torch.no_grad()
def copy_prefix(state: DecodeState, prefix: KVCache, slot: int) -> None:
    """Install a prebuilt prefix KV into ``slot``'s positions 0..P-1 — a
    device copy.  The slot stays inactive; the suffix prefill activates it."""
    _copy_prefix(state, prefix, _scalars(state, slot)[:1].to(state.tokens.device))


@torch.no_grad()
def copy_prefix_jit(state: DecodeState, prefix: KVCache, slot: int, *,
                    programs=None) -> None:
    """:func:`copy_prefix` as a compiled program, one per prefix buffer: a
    CUDA-graph capture (:mod:`._graphs`), not ``torch.jit``; the slot is a
    device scalar."""
    _graphs.run(programs, "copy_prefix", lambda s: _copy_prefix(state, prefix, s),
                device=state.tokens.device, static=(),
                inputs=(_scalars(state, slot)[:1],), bound=(state, prefix),
                mutated=state.cache)


# ---- the ragged decode step -------------------------------------------------

@torch.no_grad()
def ragged_block(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 starts: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """T tokens per slot, each slot at its OWN base position: tokens
    [B, T] run positions starts[b]..starts[b]+T-1 through the stack,
    writing their K/V into ``cache`` in place -> logits [B, T, V].  T=1 is
    the continuous-batching decode step; T=gamma+1 is speculative
    serving's verify block.  Callers own the junk-window discipline: pass
    ``starts`` already redirected for inactive slots.

    CACHE-WRITE CONTRACT: every slot must satisfy ``starts[b] + T <= S``
    (S = cache buffer length); past it the write's start is clamped to
    ``S - T`` and overwrites earlier rows (:func:`.decode._write_kv_at`).  Size the
    buffer with a margin of at least ``T - 1`` beyond the longest position
    a slot may reach.

    Token ids are not range-checked here (that would read them back to the
    host every step): the engine's ids passed the check of the prefill
    that installed them, or are the model's own picks."""
    return lm_head(params, ragged_hidden(params, config, tokens, starts, cache),
                   config)


@torch.no_grad()
def ragged_hidden(params: dict, config: ModelConfig, tokens: torch.Tensor,
                  starts: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """:func:`ragged_block` without the head: the last layer's output
    [B, T, D] before the final norm, for callers that need the logits of
    one position per slot (the speculative draft's catch-up)."""
    _check_supported(config)
    T = tokens.shape[1]
    max_len = cache.positions
    cos, sin = _rope_tables(config, max_len, tokens.device)
    pos_bt = (starts[:, None] + torch.arange(T, device=tokens.device)).clamp(
        0, max_len - 1)
    x = deq_rows(params["embed"], tokens, config.compute_dtype)  # [B, T, D]
    return cached_layers(params, config, x, cos[pos_bt], sin[pos_bt], starts, cache)


@torch.no_grad()
def decode_step(params: dict, state: DecodeState, config: ModelConfig,
                eos_id: int, *, temperature: float = 0.0,
                top_k: int | None = None,
                generator: torch.Generator | None = None) -> None:
    """One token for every active slot, each at its own position, in
    place.  Idle slots compute masked no-ops.  No host readback."""
    B, max_len = state.tokens.shape
    active = state.active
    # The last held token (from admission or the previous step) has not
    # been fed yet: feed it at position length-1.  Inactive slots write
    # their junk K/V at max_len-1, NOT 0: a slot mid-way through a chunked
    # prefill is inactive, and a junk write at 0 would clobber its first
    # chunk.  max_len-1 becomes reachable (k_pos <= length-1) only on the
    # step whose real write overwrites it.
    pos = torch.where(active, (state.length - 1).clamp(min=0), max_len - 1)
    tok = state.tokens.gather(1, pos[:, None])  # [B, 1]
    logits = ragged_block(params, config, tok, pos, state.cache)[:, 0]
    nxt = _select(logits, temperature, top_k, generator)

    # Write-gate by activity; the clamp only keeps idle lanes in bounds (a
    # full slot was already marked done).
    rows = torch.arange(B, device=pos.device)
    widx = state.length.clamp(max=max_len - 1)
    state.tokens[rows, widx] = torch.where(active, nxt, state.tokens[rows, widx])
    new_length = torch.where(active, state.length + 1, state.length)
    finished = active & ((nxt == eos_id)
                         | (new_length - state.prompt_len >= state.budget)
                         | (new_length >= max_len))
    state.length.copy_(new_length)
    state.done.logical_or_(finished)


@torch.no_grad()
def decode_step_jit(params: dict, state: DecodeState, config: ModelConfig,
                    eos_id: int, *, temperature: float = 0.0,
                    top_k: int | None = None,
                    generator: torch.Generator | None = None,
                    programs=None) -> None:
    """:func:`decode_step` as one compiled program per (config,
    temperature, top_k, eos_id) on this state: a CUDA-graph capture
    (:mod:`._graphs`), not ``torch.jit``.  On the CPU it runs the step."""
    _graphs.run(programs, "decode_step",
                lambda: decode_step(params, state, config, eos_id,
                                    temperature=temperature, top_k=top_k,
                                    generator=generator),
                device=state.tokens.device,
                static=(config, temperature, top_k, eos_id),
                bound=(params, state), mutated=state, generator=generator)


def decode_steps(params: dict, state: DecodeState, config: ModelConfig,
                 eos_id: int, n: int, *, temperature: float = 0.0,
                 top_k: int | None = None,
                 generator: torch.Generator | None = None) -> None:
    """``n`` decode steps back to back with no host readback between them:
    slots that finish mid-chain idle along masked, and admission happens
    between chains."""
    for _ in range(n):
        decode_step(params, state, config, eos_id, temperature=temperature,
                    top_k=top_k, generator=generator)


@torch.no_grad()
def decode_steps_jit(params: dict, state: DecodeState, config: ModelConfig,
                     eos_id: int, n: int, *, temperature: float = 0.0,
                     top_k: int | None = None,
                     generator: torch.Generator | None = None,
                     programs=None) -> None:
    """:func:`decode_steps` as ONE compiled program per (config, n,
    temperature, top_k, eos_id) on this state, the reference's scan of n
    steps: a CUDA-graph capture of the n steps (:mod:`._graphs`), not
    ``torch.jit``, replayed with one host call a tick.  On the CPU it runs
    the steps."""
    _graphs.run(programs, "decode_steps",
                lambda: decode_steps(params, state, config, eos_id, n,
                                     temperature=temperature, top_k=top_k,
                                     generator=generator),
                device=state.tokens.device,
                static=(config, n, temperature, top_k, eos_id),
                bound=(params, state), mutated=state, generator=generator)


# ---- the engine's weights: held at the compute dtype where they fit --------

# Device bytes kept free beside the compute copy, the state and its clone:
# the programs' graph pool and the activations outside it.
RESIDENT_HEADROOM = 4 << 30


def _free_bytes(device: torch.device) -> int | None:
    """Bytes the engine could still allocate on ``device``: the device's
    free memory and what the caching allocator holds unused; None on the
    CPU, which sets no limit."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def resident_params(params: dict, config: ModelConfig,
                    state: DecodeState) -> tuple[dict, dict]:
    """The weights an engine serves from, and what it holds for them.
    Where the compute copy (:func:`~.quant.compute_params`) fits beside
    ``state``, the state's clone that each capture's warm-up makes and
    :data:`RESIDENT_HEADROOM`, that copy: no program casts a weight again.
    Otherwise ``params``, cast on every call.  The record: ``resident``
    (1 when every weight the programs cast whole is at the compute dtype),
    the copy's ``bytes`` and its ``leaves``."""
    dt = config.compute_dtype
    need = compute_bytes(params, dt)
    spare = _free_bytes(state.tokens.device)
    clone = sum(t.nbytes for t in _graphs.tensors(state))
    if need and spare is not None and spare < need + clone + RESIDENT_HEADROOM:
        return params, {"resident": 0, "bytes": 0, "leaves": 0}
    tree = compute_params(params, dt)
    copied = [b for a, b in zip(_graphs.tensors(params), _graphs.tensors(tree))
              if a is not b]
    return tree, {"resident": 1, "bytes": sum(t.nbytes for t in copied),
                  "leaves": len(copied)}


# ---- host-side engine (pure control plane) ----------------------------------

class ServingEngine:
    """Continuous-batching orchestrator: a request queue over the slotted
    decode state, on the device that holds ``params``.

    ``prompt_pad`` is the static prefill bucket — an int, or a tuple of
    bucket lengths: each admission pads to the SMALLEST bucket covering
    its prompt.  Prompts longer than the largest bucket are rejected.
    ``eos_id`` < 0 disables EOS (budget-only termination).  Sampling
    (``temperature`` > 0) draws from ``generator``.

    ``prefill_chunk`` (optional) bounds head-of-line blocking: an
    admission whose bucket is wider than the chunk prefills one chunk per
    tick, interleaved with the other slots' decode steps.  Buckets must be
    chunk multiples.  ``steps_per_tick`` decode steps run per tick with no
    readback between them.  ``buffer_margin`` adds cache and token rows
    past ``max_len`` (which still bounds submissions) for subclasses whose
    device programs write fixed-width windows at the frontier.

    ``record_routes`` (an MoE config) keeps each finished request's expert
    choices on the device: :attr:`routes` maps its id to the top-k expert
    ids [L_moe, positions, k] int16 of every position it fed through the
    expert layers (its prompt and its tokens but the last; -1 where a
    prefix copy filled the cache), copied from the slot when it is
    harvested, with no readback.

    Streaming: ``on_tokens(rid, [token_ids])`` fires after each tick with
    the GENERATED tokens newly committed for that request; it costs one
    extra readback per tick, and none when no callback is set.

    The weights are fixed for the engine's life.  It serves from a copy of
    ``params`` at the compute dtype, made once when it is built, where the
    device holds that copy beside the state (:func:`resident_params`, whose
    record is :attr:`weights`); otherwise each program call casts them.
    Later changes to ``params`` do not reach a resident copy.

    ``tracer`` (an :class:`~.obs.Tracer`, settable later; None by default)
    records a ``tick`` span per :meth:`step` with the five phase spans
    :data:`~.obs.PHASES` as its children, a span per program call (named
    after the program, with the request, slot, real prompt tokens, first
    position or steps it runs) over its ``dispatch`` and ``replay`` spans
    (:class:`~._graphs.Programs`), every device-to-host read and the stall
    that follows it (:meth:`_read`), and each request's ``queued``,
    ``admitted``, ``first_token`` and ``finished``.  Its export carries
    :attr:`metrics`, the programs' counts, the launches of the decode and
    chunk attention kernels and of the grouped GEMM, :attr:`weights`, for
    an MoE config the routed layer's counts (``moe``:
    :class:`~.moe.ExpertCounts`) and for an MLA config latent attention's
    (``mla``: :class:`~.obs.LatentCounts`), each added to on the device by
    every program captured while traced.

    All device work goes through the compiled programs, as the reference's
    engine does: on CUDA each replays its CUDA graph from this engine's
    :attr:`programs` (one graph per bucket or chunk width, and for an MLA
    config per chunk start too, one decode program per
    ``steps_per_tick``), on the CPU it runs its body.  The
    queue, slot choice, harvest and streaming stay on the host between
    replays.  :meth:`_program` is the one place that calls them.
    """

    def __init__(self, params: dict, config: ModelConfig, *, slots: int,
                 max_len: int, prompt_pad: int | tuple[int, ...],
                 eos_id: int = -1,
                 temperature: float = 0.0, top_k: int | None = None,
                 generator: torch.Generator | None = None,
                 steps_per_tick: int = 1,
                 prefill_chunk: int | None = None,
                 buffer_margin: int = 0,
                 on_tokens: Callable[[int, list[int]], None] | None = None,
                 tracer: obs.Tracer | None = None,
                 record_routes: bool = False) -> None:
        buckets = ((prompt_pad,) if isinstance(prompt_pad, int)
                   else tuple(sorted(set(prompt_pad))))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"bad prompt_pad buckets {prompt_pad!r}")
        if buckets[-1] + 1 > max_len:
            raise ValueError(
                f"prompt_pad {buckets[-1]} + 1 exceeds max_len {max_len}")
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")
        if steps_per_tick < 1:
            raise ValueError("steps_per_tick must be >= 1")
        if prefill_chunk is not None and (
                prefill_chunk < 1
                or any(b % prefill_chunk for b in buckets)):
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= 1 and divide "
                f"every bucket {buckets}")
        self.config = config
        self.device = params["final_norm"].device
        self.slots = slots
        self.max_len = max_len
        self.buckets = buckets
        self.prompt_pad = buckets[-1]
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.generator = generator
        self.steps_per_tick = steps_per_tick
        self.prefill_chunk = prefill_chunk
        self.on_tokens = on_tokens
        # rid -> emission cursor, seeded at submit() with the prompt length;
        # empty when no callback is set.
        self._streamed: dict[int, int] = {}
        self.state = init_state(config, slots, max_len + buffer_margin,
                                device=self.device, record_routes=record_routes)
        self.params, self.weights = resident_params(params, config, self.state)
        self.routes: dict[int, torch.Tensor] = {}
        # The captured programs of this engine, on one graph memory pool.
        self.programs = _graphs.Programs()
        # (id, prompt-or-suffix, max_new, prefix id or None)
        self._queue: list[tuple[int, list[int], int, int | None]] = []
        # slot -> (rid, max_len row, prompt_len, max_new, next start, chunk)
        self._prefilling: dict[
            int, tuple[int, np.ndarray, int, int, int, int]] = {}
        # prefix id -> (tokens, KVCache [L, 1, P, KV, H] on the device)
        self._prefixes: dict[int, tuple[list[int], KVCache]] = {}
        self._next_id = 0
        self._results: dict[int, list[int]] = {}
        self.metrics = {"admitted": 0, "decode_steps": 0, "finished": 0,
                        "prefill_chunks": 0, "prefix_admits": 0}
        self.tracer = tracer

    @property
    def tracer(self) -> obs.Tracer | None:
        return self._tracer

    @tracer.setter
    def tracer(self, tracer: obs.Tracer | None) -> None:
        """Trace from now on (None: stop); the programs take it too."""
        self._tracer = self.programs.tracer = tracer
        self.expert_counts = (moe.ExpertCounts(self.device)
                              if tracer is not None and self.config.moe is not None
                              else None)
        self.latent_counts = (obs.LatentCounts(self.device)
                              if tracer is not None and self.config.mla is not None
                              else None)
        if tracer is not None:
            # The carries hold what they read, not the engine: no cycle
            # through the tracer keeps a dropped engine's weights and state
            # on the device until the collector runs.
            metrics, programs, weights = self.metrics, self.programs, self.weights
            tracer.carry("engine", lambda: dict(metrics))
            tracer.carry("programs", programs.counts)
            tracer.carry("decode_attention", lambda: {
                "launches": programs.launches[_kernels.DECODE_ATTN.name]})
            tracer.carry("chunk_attention", lambda: {
                "launches": programs.launches[_kernels.CHUNK_ATTN.name]})
            tracer.carry("grouped_mm", lambda: {
                "launches": programs.launches[_kernels.GROUPED_MM.name]})
            tracer.carry("weights", lambda: dict(weights))
            if self.expert_counts is not None:
                tracer.carry("moe", self.expert_counts.snapshot)
            if self.latent_counts is not None:
                tracer.carry("mla", self.latent_counts.snapshot)

    def _program(self, name: str, *args, **kw):
        """Run the device program ``name`` (``"admit"``, ``"decode_steps"``,
        ...): its ``_jit`` form on this engine's :attr:`programs`.  Host
        arrays go in as host tensors; the program copies them into its
        static buffers."""
        return _PROGRAMS[name](*args, programs=self.programs, **kw)

    def _run(self, name: str, work: dict, *args, **kw):
        """:meth:`_program`, traced under a span named after the program,
        whose attributes ``work`` says what it runs (request, slot, prompt
        tokens, first position, steps); an MoE config's routed layer adds
        to :attr:`expert_counts` inside it, an MLA config's latent attention
        to :attr:`latent_counts`."""
        if self.tracer is None:
            return self._program(name, *args, **kw)
        with (self.tracer.span(name, **work), moe.counting(self.expert_counts),
              attention.latent_counting(self.latent_counts)):
            return self._program(name, *args, **kw)

    def _read(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host: the engine's one device-to-host read, which
        waits for the device; the tracer counts it and notes when the
        device was left with nothing queued."""
        host = t.cpu()
        if self.tracer is not None:
            self.tracer.readback()
        return host

    # -- request surface --

    def register_prefix(self, tokens: list[int] | np.ndarray) -> int:
        """Compute a shared prompt prefix's KV once; requests submitted
        with ``prefix=pid`` copy it and prefill only their suffix."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("prefix must be non-empty")
        if len(tokens) + self.buckets[0] > self.max_len:
            raise ValueError(
                f"prefix {len(tokens)} + smallest bucket {self.buckets[0]} "
                f"exceeds max_len {self.max_len}")
        cache = self._run("build_prefix_cache", {"prompt_tokens": len(tokens)},
                          self.params, self.config, _host(tokens))
        pid = self._next_id
        self._next_id += 1
        self._prefixes[pid] = (tokens, cache)
        return pid

    def unregister_prefix(self, pid: int) -> None:
        """Release a prefix's device KV.  Mid-prefill slots already copied
        it; only queued requests still reference the pid, so eviction is
        refused while any do."""
        if pid not in self._prefixes:
            raise ValueError(f"unknown prefix id {pid}")
        if any(q[3] == pid for q in self._queue):
            raise ValueError(
                f"prefix {pid} still referenced by queued requests")
        del self._prefixes[pid]

    def submit(self, prompt: list[int] | np.ndarray, max_new: int,
               prefix: int | None = None) -> int:
        """Queue a request.  With ``prefix``, ``prompt`` is the SUFFIX after
        the registered prefix; the result row is the full prefix + suffix +
        generated sequence."""
        prompt = [int(t) for t in prompt]
        if not 0 < len(prompt) <= self.prompt_pad:
            raise ValueError(
                f"prompt length {len(prompt)} outside (0, {self.prompt_pad}]")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        plen = len(prompt)
        if prefix is not None:
            if prefix not in self._prefixes:
                raise ValueError(f"unknown prefix id {prefix}")
            ptoks = self._prefixes[prefix][0]
            pad_s = next(b for b in self.buckets if b >= len(prompt))
            if len(ptoks) + pad_s > self.max_len:
                raise ValueError(
                    f"prefix {len(ptoks)} + suffix bucket {pad_s} exceeds "
                    f"max_len {self.max_len}")
            plen += len(ptoks)
        if plen + max_new > self.max_len:
            raise ValueError(
                f"prompt {plen} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
        rid = self._next_id
        self._next_id += 1
        if self.on_tokens is not None:
            self._streamed[rid] = plen
        self._queue.append((rid, prompt, max_new, prefix))
        if self.tracer is not None:
            self.tracer.request(rid, "queued")
        return rid

    # -- engine internals --

    def _free_slots(self) -> list[int]:
        seq = self._read(self.state.seq_id).tolist()
        return [i for i in range(self.slots)
                if seq[i] < 0 and i not in self._prefilling]

    def _advance_prefill(self, slot: int) -> None:
        """One chunk of ``slot``'s prefill.  The chunk holding the prompt's
        last token finishes through :func:`admit_final_chunk`; chunks past
        it never run."""
        rid, row, plen, max_new, start, ch = self._prefilling[slot]
        work = {"rid": rid, "slot": slot, "prompt_tokens": min(ch, plen - start),
                "first_pos": start}
        if start + ch < plen:  # a later chunk holds position plen-1
            self._run("prefill_chunk", work, self.params, self.state, self.config,
                      slot, _host(row[start:start + ch]), start)
            self._prefilling[slot] = (rid, row, plen, max_new, start + ch, ch)
        else:
            self._run(
                "admit_final_chunk", work, self.params, self.state, self.config, slot,
                _host(row), _host(row[start:start + ch]), start, plen, rid,
                max_new, self.eos_id, temperature=self.temperature,
                top_k=self.top_k, generator=self.generator)
            del self._prefilling[slot]
            self.metrics["admitted"] += 1
            self._post_admit(slot, row, plen)
        self.metrics["prefill_chunks"] += 1

    def _advance_prefills(self) -> None:
        for slot in list(self._prefilling):
            self._advance_prefill(slot)

    def _admit_pending(self) -> None:
        for slot in self._free_slots():
            if not self._queue:
                break
            rid, prompt, max_new, pfx = self._queue.pop(0)
            if self.tracer is not None:
                self.tracer.request(rid, "admitted")
            pad = next(b for b in self.buckets if b >= len(prompt))
            if pfx is not None:
                # Copy the prebuilt prefix KV into the slot, then prefill
                # only the suffix at start=P through the chunk machinery
                # (an unchunked engine takes the suffix bucket as one chunk).
                ptoks, pcache = self._prefixes[pfx]
                P = len(ptoks)
                row = np.zeros((self.max_len,), np.int64)
                row[:P] = ptoks
                row[P:P + len(prompt)] = prompt
                self._run("copy_prefix", {"rid": rid, "slot": slot,
                                          "prompt_tokens": 0, "first_pos": 0},
                          self.state, pcache, slot)
                self.metrics["prefix_admits"] += 1
                ch = (self.prefill_chunk
                      if self.prefill_chunk and pad > self.prefill_chunk
                      else pad)
                self._prefilling[slot] = (rid, row, P + len(prompt), max_new,
                                          P, ch)
                self._advance_prefill(slot)
                continue
            if self.prefill_chunk and pad > self.prefill_chunk:
                # The BUCKET (not the prompt) decides: a short prompt in a
                # wide bucket would otherwise pay a whole-bucket prefill.
                # Its first chunk runs now; later ones one per tick.
                row = np.zeros((self.max_len,), np.int64)
                row[:len(prompt)] = prompt
                self._prefilling[slot] = (rid, row, len(prompt), max_new, 0,
                                          self.prefill_chunk)
                self._advance_prefill(slot)
                continue
            padded = np.zeros((pad,), np.int64)
            padded[:len(prompt)] = prompt
            self._run("admit", {"rid": rid, "slot": slot, "prompt_tokens": len(prompt),
                                "first_pos": 0},
                      self.params, self.state, self.config, slot, _host(padded),
                      len(prompt), rid, max_new, self.eos_id,
                      temperature=self.temperature, top_k=self.top_k,
                      generator=self.generator)
            self.metrics["admitted"] += 1
            self._post_admit(slot, padded, len(prompt))

    def _post_admit(self, slot: int, padded: np.ndarray,
                    prompt_len: int) -> None:
        """Hook for subclasses that keep auxiliary per-slot device state
        (the speculative engine prefills its draft cache here)."""

    def _harvest(self) -> None:
        done = self._read(self.state.done).numpy()
        if not done.any():
            return
        seq = self._read(self.state.seq_id).numpy()
        length = self._read(self.state.length).numpy()
        tokens = self._read(self.state.tokens).numpy()
        clear = []
        for slot in np.nonzero(done)[0]:
            rid = int(seq[slot])
            if rid >= 0:
                self._results[rid] = tokens[slot, :int(length[slot])].tolist()
                if self.state.cache.routes is not None:
                    self.routes[rid] = self.state.cache.routes[
                        :, slot, :int(length[slot]) - 1].clone()
                self.metrics["finished"] += 1
                if self.tracer is not None:
                    # without a stream, a request's tokens first reach the
                    # host here
                    self.tracer.request(rid, "first_token")
                    self.tracer.request(rid, "finished")
                # The final emission happened at the end of the tick that
                # finished this slot, before this harvest.
                self._streamed.pop(rid, None)
            clear.append(int(slot))
        idx = torch.tensor(clear, device=self.device)
        self.state.seq_id[idx] = -1
        self.state.done[idx] = False
        self.state.length[idx] = 0
        self.state.budget[idx] = 0

    def step(self) -> None:
        """One engine tick: harvest finished -> advance chunked prefills by
        one chunk each -> admit from the queue -> one decode tick (if
        anything is active) -> stream; each a phase span of the tick's
        span when traced."""
        phases = (self._harvest, self._prefill_phase, self._admit_pending,
                  self._decode_phase, self._stream_phase)
        tr = self.tracer
        if tr is None:
            for phase in phases:
                phase()
            return
        with tr.span("tick"):
            for name, phase in zip(obs.PHASES, phases):
                with tr.span(name):
                    phase()

    def _prefill_phase(self) -> None:
        if self._prefilling:
            self._advance_prefills()

    def _decode_phase(self) -> None:
        if bool(self._read(self.state.active.any())):
            self._decode_tick()

    def _stream_phase(self) -> None:
        if self.on_tokens is not None:
            self._emit_stream()

    def _emit_stream(self) -> None:
        """Fire ``on_tokens`` with each live request's newly committed
        generated tokens.  Runs before harvest clears a finished slot, so
        the final tokens, EOS included, stream before run() returns them."""
        seq = self._read(self.state.seq_id).tolist()
        length = self._read(self.state.length).tolist()
        tokens = None
        for slot in range(self.slots):
            sent = self._streamed.get(seq[slot]) if seq[slot] >= 0 else None
            if sent is None:
                continue
            cur = length[slot]
            if cur > sent:
                if tokens is None:  # one readback, only when needed
                    tokens = self._read(self.state.tokens).numpy()
                if self.tracer is not None:
                    self.tracer.request(seq[slot], "first_token")
                self.on_tokens(seq[slot], tokens[slot, sent:cur].tolist())
                self._streamed[seq[slot]] = cur

    def _decode_tick(self) -> None:
        """``steps_per_tick`` decode steps in one program: one replay a tick."""
        kw = dict(temperature=self.temperature, top_k=self.top_k,
                  generator=self.generator)
        work = {"steps": self.steps_per_tick}
        if self.steps_per_tick == 1:
            self._run("decode_step", work, self.params, self.state, self.config,
                      self.eos_id, **kw)
        else:
            self._run("decode_steps", work, self.params, self.state, self.config,
                      self.eos_id, self.steps_per_tick, **kw)
        self.metrics["decode_steps"] += self.steps_per_tick

    def run(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive until queue and slots drain; returns {request id: tokens
        (prompt + generated, EOS included when emitted)}."""
        for _ in range(max_steps):
            self.step()
            if not self._queue and not self._prefilling and not bool(
                    self._read((self.state.seq_id >= 0).any())):
                break
        self._harvest()
        return dict(self._results)


def _host(a) -> torch.Tensor:
    """A host int64 tensor of ``a``, which a program copies to the device."""
    return torch.from_numpy(np.array(a, dtype=np.int64))


# The engine's device programs by name (:meth:`ServingEngine._program`).
_PROGRAMS = {"admit": admit_jit, "prefill_chunk": prefill_chunk_jit,
             "admit_final_chunk": admit_final_chunk_jit,
             "build_prefix_cache": build_prefix_cache_jit,
             "copy_prefix": copy_prefix_jit, "decode_step": decode_step_jit,
             "decode_steps": decode_steps_jit}
