"""Speculative decoding: draft cheap, verify exact, accept in bulk — the
counterpart of ``tputopo/workloads/speculative.py``.

A decode step streams every weight once for one token.  Speculative
decoding amortizes that stream: a cheap DRAFT model proposes ``gamma``
tokens one by one, the target scores all of them in ONE forward of width
gamma+1, and the longest prefix whose greedy argmax agrees is committed
with the target's own next token: 1..gamma+1 tokens per target stream.

Lossless by construction: with greedy selection the committed sequence is
the target's greedy decode, whatever the draft proposes; the draft only
decides how many target steps are skipped.  One numerics caveat: the
verify forward is gamma+1 wide where plain decode is 1 wide, and neither
XLA nor cuBLAS promises bitwise-equal reductions across shapes, so at bf16
two logits within an ulp of each other can argmax differently between the
two widths.  Parity is exact at f32 (pinned by the tests).

- The draft is the target's first ``draft_layers`` layers with the embed,
  final norm and head shared: :func:`draft_slice` slices the same stacked
  tensors (views, no copy), raw, int8, int4 and LoRA-wrapped leaves alike.
- :func:`spec_generate` (one sequence) is two compiled programs: the
  prefill of both caches, and ONE verify step whose positions (the
  committed ``length``, the draft's ``dlen``) are device scalars, its
  windows gathers and masked writes through the serving engine's ragged
  block at B = 1.  The reference's ``lax.while_loop`` becomes rounds: the
  step is replayed ceil((total - length) / (gamma + 1)) times, a lower
  bound on the steps still needed (each commits 1..gamma+1 tokens), and
  then ``length`` is read back, once a round, until it reaches the total.
  No step runs past the end, so the tokens and ``target_steps`` are the
  reference's.  Junk K/V past the committed length is overwritten before
  any query attends it, so rejected drafts need no rollback.
- :class:`SpecServingEngine` is speculative continuous batching over the
  serving engine's slots: every slot drafts and accepts at its own
  position through one ragged verify block (:func:`~.serving.ragged_block`
  with T = gamma+1) per tick, with per-slot EOS and budget caps.
  :func:`spec_tick` reads nothing back; the engine reads the tick's
  accepted count, as the reference's ``int(accepted)`` does.

The reference jits ``spec_generate``, ``spec_tick`` and ``_draft_prefill``;
here each is a CUDA-graph capture (:mod:`._graphs`) under the same name,
replayed on CUDA and run eagerly on the CPU.  ``*_eager`` name their
bodies run op by op on any device (the engine's eager-driven twin, the
card's comparisons).

``lax.dynamic_slice`` clamps its start into the array where a Python slice
would come back short; the windows here replicate the clamp (the gathers
of :func:`spec_tick` and of the verify step).  The port's
:class:`~.serving.DecodeState` has no step counter, so :func:`spec_tick`
has no ``step + 1``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tputopo_torch import _graphs
from tputopo_torch.decode import KVCache, _block_hidden, _block_step
from tputopo_torch.model import (ModelConfig, _check_supported, _rope_tables, check_plain,
                                 check_token_ids, lm_head)
from tputopo_torch.serving import (DecodeState, ServingEngine, _host, _slot_prefill,
                                   ragged_block, ragged_hidden)


def _acceptance_row(drafts: torch.Tensor, targets: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The acceptance rule, shared by both paths: drafts [B, gamma] against
    targets [B, gamma+1] (the target's argmax after each verify position)
    -> (row [B, gamma+1], n_accept [B]).  ``row`` is the commit candidate:
    the accepted draft prefix, then the target's own token at index
    n_accept.  n_accept is the first disagreement, as ``jnp.argmin`` over
    the agreement row padded with False gives it: torch's argmin takes no
    bool, so the row goes as int32, and its ties resolve to the first
    index, as jnp's do."""
    B, gamma = drafts.shape
    agree = targets[:, :gamma] == drafts
    padded = torch.cat([agree, agree.new_zeros((B, 1))], dim=1)
    n_accept = padded.to(torch.int32).argmin(dim=1)
    keep = torch.arange(gamma + 1, device=drafts.device)[None, :] < n_accept[:, None]
    row = torch.where(keep, torch.cat([drafts, targets[:, gamma:]], dim=1), targets)
    return row, n_accept


def draft_slice(params: dict, config: ModelConfig,
                draft_layers: int) -> tuple[dict, ModelConfig]:
    """The draft model: the target's first ``draft_layers`` layers with the
    embed, final norm and head shared — views of the same stacked tensors,
    for raw, quantized and LoRA-wrapped leaves (every tensor of a layer
    leaf carries the leading layer axis)."""
    if not 0 < draft_layers < config.n_layers:
        raise ValueError(
            f"draft_layers must be in (0, {config.n_layers}), got {draft_layers}")

    def cut(t):
        return ({k: cut(v) for k, v in t.items()} if isinstance(t, dict)
                else t[:draft_layers])

    draft_params = dict(params)
    draft_params["layers"] = cut(params["layers"])
    return draft_params, dataclasses.replace(config, n_layers=draft_layers)


class _SpecLoop(NamedTuple):
    """:func:`spec_generate`'s device state between verify steps: the
    reference's ``while_loop`` carry less ``target_steps``, which the host
    counts (one per step it replays)."""

    tokens: torch.Tensor    # [1, max_len] committed tokens, junk past length
    tcache: KVCache         # the target's, [L, 1, max_len, KV, H]
    dcache: KVCache         # the draft's
    length: torch.Tensor    # [1] int64: tokens committed
    dlen: torch.Tensor      # [1] int64: tokens the draft has seen
    accepted: torch.Tensor  # [] int64: tokens committed from the draft


def _spec_prefill(params: dict, draft_params: dict, config: ModelConfig,
                  draft_config: ModelConfig, prompt: torch.Tensor,
                  max_len: int) -> _SpecLoop:
    """Prefill both caches on ``prompt`` [1, P]; the target's last-position
    logits give the first committed token -> the loop's first state."""
    device = prompt.device
    P = prompt.shape[1]
    cos, sin = _rope_tables(config, max_len, device)
    tokens = torch.zeros((1, max_len), dtype=torch.long, device=device)
    tokens[:, :P] = prompt
    tcache = KVCache.create(config, 1, max_len, device=device)
    dcache = KVCache.create(draft_config, 1, max_len, device=device)
    tlogits = _block_step(params, config, prompt, 0, tcache, cos, sin)
    _block_hidden(draft_params, draft_config, prompt, 0, dcache, cos, sin)
    tokens[:, P] = torch.argmax(tlogits[:, -1], dim=-1)

    def scalar(v: int) -> torch.Tensor:
        return torch.full((1,), v, dtype=torch.long, device=device)

    return _SpecLoop(tokens, tcache, dcache, scalar(P + 1), scalar(P),
                     torch.zeros((), dtype=torch.long, device=device))


def _spec_verify(params: dict, draft_params: dict, config: ModelConfig,
                 draft_config: ModelConfig, loop: _SpecLoop, total: int,
                 gamma: int) -> None:
    """One verify step of :func:`spec_generate`, in place on ``loop``: the
    reference's ``while_loop`` body with every position a device scalar,
    through the serving engine's ragged block at B = 1.  Nothing is read
    back.  The buffers hold ``total + gamma + 1`` rows, so no window
    clamps; the gather clamps as ``dynamic_slice`` would all the same."""
    tokens, tcache, dcache, length, dlen, accepted = loop
    max_len = tokens.shape[1]
    G1 = gamma + 1
    steps = torch.arange(G1, device=tokens.device)

    # 1. Draft catch-up: feed the draft every committed token it has not
    # seen as one fixed-width block; entries past the real gap are junk
    # whose K/V rows are overwritten before any query attends them.  The
    # first draft token is free: the block holds the last committed
    # token's position, and only that row goes to the head.
    gap = tokens.gather(1, dlen.clamp(max=max_len - G1)[:, None] + steps)
    x = ragged_hidden(draft_params, draft_config, gap, dlen, dcache)
    last_row = (length - 1 - dlen)[:, None, None].expand(1, 1, x.shape[-1])
    drafts = [torch.argmax(lm_head(draft_params, x.gather(1, last_row),
                                   draft_config)[:, 0], dim=-1)]
    dlen.copy_(length)  # the draft has now seen tokens[0:length]
    # 2. The remaining gamma-1 draft tokens, one by one.
    for i in range(gamma - 1):
        lg = ragged_block(draft_params, draft_config, drafts[-1][:, None], length + i,
                          dcache)
        drafts.append(torch.argmax(lg[:, 0], dim=-1))
    drafts = torch.stack(drafts, dim=1)  # [1, gamma]
    # 3. Verify: ONE target forward over [last, draft_1..draft_gamma] at
    # positions length-1.. — the amortized weight stream.
    block = torch.cat([tokens.gather(1, (length - 1)[:, None]), drafts], dim=1)
    targets = torch.argmax(ragged_block(params, config, block, length - 1, tcache),
                           dim=-1)
    row, n_accept = _acceptance_row(drafts, targets)
    # 4. Commit the accepted drafts and the target's own next token,
    # capped by the budget (never past total), as a masked full-row write.
    commit = torch.minimum(n_accept + 1, total - length)  # [1]
    off = torch.arange(max_len, device=tokens.device)[None, :] - length[:, None]
    use = (off >= 0) & (off < commit[:, None])
    tokens.copy_(torch.where(use, row.gather(1, off.clamp(0, gamma)), tokens))
    accepted.add_(torch.minimum(n_accept, commit)[0])
    length.add_(commit)


def _spec_generate(params: dict, prompt, config: ModelConfig, max_new: int,
                   draft_layers: int, gamma: int, max_len: int | None,
                   programs: _graphs.Programs | None,
                   jit: bool) -> tuple[torch.Tensor, dict]:
    """:func:`spec_generate`'s host loop: the prefill, then rounds of verify
    steps with one readback of the committed length a round; the two
    programs replay with ``jit``, else their bodies run op by op."""
    check_plain(config, "speculative decoding")
    c = config
    _check_supported(c)
    device = params["final_norm"].device
    prompt = torch.as_tensor(prompt)
    B, P = prompt.shape
    if B != 1:
        raise ValueError("spec_generate is single-sequence (B=1); the "
                         "batched analog is the serving engine's slots")
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    total, G1 = P + max_new, gamma + 1
    # Fixed-width blocks write up to gamma tokens past the committed
    # length; the buffers get that margin.
    max_len = max(max_len or 0, total + G1)
    draft_params, draft_cfg = draft_slice(params, c, draft_layers)
    static = (c, draft_layers, gamma, max_new, max_len)

    def run(name, body, inputs=(), **kw):
        if not jit:
            return body(*(t.to(device) for t in inputs))
        return _graphs.run(programs, name, body, device=device, static=static,
                           inputs=inputs, **kw)

    if jit:
        check_token_ids(prompt, c)
    loop = run("spec_prefill",
               lambda p: _spec_prefill(params, draft_params, c, draft_cfg, p, max_len),
               inputs=(prompt,), bound=params)
    length, target_steps = P + 1, 1
    while length < total:
        for _ in range(-(-(total - length) // G1)):
            run("spec_step", lambda: _spec_verify(params, draft_params, c, draft_cfg,
                                                  loop, total, gamma),
                bound=(params, loop), mutated=loop)
            target_steps += 1
        length = int(loop.length[0])  # the round's one readback
    stats = {"target_steps": target_steps, "drafted_accepted": int(loop.accepted),
             "max_new": max_new}
    return loop.tokens[:, :total].clone(), stats


@torch.no_grad()
def spec_generate(params: dict, prompt: torch.Tensor, config: ModelConfig, *,
                  max_new: int, draft_layers: int, gamma: int = 4,
                  max_len: int | None = None,
                  programs: _graphs.Programs | None = None) -> tuple[torch.Tensor, dict]:
    """Greedy speculative decode on the device that holds ``params``:
    prompt [1, P] -> ([1, P + max_new] token ids, stats).  Token for token
    the greedy output of :func:`~.decode.generate`; ``stats`` holds
    ``target_steps`` (target forwards paid, the prefill included),
    ``drafted_accepted`` (tokens committed straight from the draft) and
    ``max_new``.

    The reference's jitted ``spec_generate`` as two CUDA-graph captures
    (:mod:`._graphs`), not ``torch.jit``: the prefill, one per prompt
    width and static arguments, and the device-scalar verify step, replayed
    in rounds with one readback each.  The prompt is checked on its way
    into the graph's static buffer; the tokens returned are a fresh copy.
    On the CPU the same bodies run eagerly."""
    return _spec_generate(params, prompt, config, max_new, draft_layers, gamma,
                          max_len, programs, jit=True)


@torch.no_grad()
def spec_generate_eager(params: dict, prompt: torch.Tensor, config: ModelConfig, *,
                        max_new: int, draft_layers: int, gamma: int = 4,
                        max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """:func:`spec_generate` with its bodies run op by op, on any device."""
    return _spec_generate(params, prompt, config, max_new, draft_layers, gamma,
                          max_len, None, jit=False)


# ---- speculative continuous batching ----------------------------------------

@torch.no_grad()
def spec_tick_eager(params: dict, draft_params: dict, state: DecodeState,
                    dcache: KVCache, dlen: torch.Tensor, config: ModelConfig,
                    draft_config: ModelConfig, eos_id: int, gamma: int) -> torch.Tensor:
    """One speculative tick for every active slot, in place: draft catch-up
    -> gamma per-slot draft tokens -> ONE ragged target verify block ->
    per-slot acceptance and EOS/budget-capped commits.  Each slot commits
    1..gamma+1 tokens per target stream, independently of the others.
    ``state``, the draft cache ``dcache`` and the draft's per-slot
    ``dlen`` are written in place; returns the tick's accepted draft
    tokens over active slots, a device scalar.  No host readback.

    Junk-window discipline, as in :func:`~.serving.decode_step`: inactive
    slots' windows go to the buffer's tail, and every junk K/V row is
    masked or overwritten before a query attends it.  The engine's buffers
    carry a gamma+1 margin past the logical max_len, so an active slot's
    verify window never clamps.  The port's state has no step counter, so
    the reference's ``step + 1`` has no counterpart here."""
    B, buf_len = state.tokens.shape
    G1 = gamma + 1
    active = state.active
    safe = buf_len - G1  # junk-window base for inactive slots
    steps = torch.arange(G1, device=state.tokens.device)

    # 1. Draft catch-up (the gap length - dlen is at most gamma+1 between
    # ticks; an admission resets dlen through the draft prefill).  Each
    # window starts at most at `safe`, so it stays in the buffer, which is
    # dynamic_slice's clamp.
    cu_start = torch.where(active, dlen.clamp(max=safe), safe)
    gap = state.tokens.gather(1, cu_start[:, None] + steps)
    x = ragged_hidden(draft_params, draft_config, gap, cu_start, dcache)
    dlen.copy_(torch.where(active, state.length, dlen))

    # 2. gamma draft tokens per slot.  The first is free: the catch-up
    # block holds the last committed token's position, whose row alone
    # goes to the head.
    pos0 = torch.where(active, (state.length - 1).clamp(min=0), safe)
    last = state.tokens.gather(1, pos0[:, None])[:, 0]
    first_idx = (pos0 - cu_start).clamp(0, gamma)
    x1 = x.gather(1, first_idx[:, None, None].expand(B, 1, x.shape[-1]))
    drafts = [torch.argmax(lm_head(draft_params, x1, draft_config)[:, 0], dim=-1)]
    for i in range(gamma - 1):
        lg = ragged_block(draft_params, draft_config, drafts[-1][:, None],
                          pos0 + 1 + i, dcache)
        drafts.append(torch.argmax(lg[:, 0], dim=-1))
    drafts = torch.stack(drafts, dim=1)  # [B, gamma]

    # 3. Verify: ONE target forward per slot over [last, d_1..d_gamma] at
    # positions length-1.. — the amortized weight stream.
    vblock = torch.cat([last[:, None], drafts], dim=1)
    targets = torch.argmax(ragged_block(params, config, vblock, pos0, state.cache),
                           dim=-1)  # [B, G1]

    # 4. Acceptance and commit count per slot, capped by the budget and at
    # the first EOS (argmax over bool as int32: the first True, as jnp's).
    row, n_accept = _acceptance_row(drafts, targets)
    generated = state.length - state.prompt_len
    commit = torch.minimum(n_accept + 1, state.budget - generated)
    is_eos = row == eos_id
    eos_idx = is_eos.to(torch.int32).argmax(dim=1)
    has_eos = is_eos.any(dim=1)
    commit = torch.where(has_eos, torch.minimum(commit, eos_idx + 1), commit)
    commit = torch.where(active, commit, 0)

    # 5. Masked full-row token write (no window clamping to reason about).
    off = torch.arange(buf_len, device=state.tokens.device)[None, :] - state.length[:, None]
    use = (off >= 0) & (off < commit[:, None]) & active[:, None]
    state.tokens.copy_(torch.where(use, row.gather(1, off.clamp(0, gamma)),
                                   state.tokens))
    new_length = state.length + commit
    eos_committed = has_eos & (eos_idx + 1 <= commit)
    finished = active & (eos_committed | (new_length - state.prompt_len >= state.budget)
                         | (new_length >= buf_len))
    accepted = torch.where(active, torch.minimum(n_accept, commit), 0).sum()
    state.length.copy_(new_length)
    state.done.logical_or_(finished)
    return accepted


@torch.no_grad()
def spec_tick(params: dict, draft_params: dict, state: DecodeState,
              dcache: KVCache, dlen: torch.Tensor, config: ModelConfig,
              draft_config: ModelConfig, eos_id: int, gamma: int, *,
              programs: _graphs.Programs | None = None) -> torch.Tensor:
    """:func:`spec_tick_eager` as one compiled program per (config, draft
    config, gamma, eos_id) on these trees, the reference's jitted
    ``spec_tick``: a CUDA-graph capture (:mod:`._graphs`), not
    ``torch.jit``.  Returns the accepted count as the graph's output, a
    device scalar the next replay overwrites.  On the CPU it runs the
    tick."""
    return _graphs.run(programs, "spec_tick",
                       lambda: spec_tick_eager(params, draft_params, state, dcache, dlen,
                                               config, draft_config, eos_id, gamma),
                       device=state.tokens.device,
                       static=(config, draft_config, gamma, eos_id),
                       bound=(params, draft_params, state, dcache, dlen),
                       mutated=(state, dcache, dlen))


def _draft_scalars(dcache: KVCache, slot: int, prompt_len: int) -> torch.Tensor:
    """The draft prefill's scalars (slot, start 0, prompt length) as a host
    int64 vector; the slot must lie in range (a device gather would
    fault)."""
    if not 0 <= slot < dcache.k.shape[1]:
        raise ValueError(f"slot {slot} outside [0, {dcache.k.shape[1]})")
    return torch.tensor([slot, 0, prompt_len], dtype=torch.long)


def _draft_prefill_body(draft_params: dict, config: ModelConfig, dcache: KVCache,
                        dlen: torch.Tensor | None, prompt: torch.Tensor,
                        a: torch.Tensor) -> None:
    """The slot ``a[0]``'s rows of the draft cache prefilled on ``prompt``
    at start ``a[1]``, and ``dlen[slot]`` set to ``a[2]``, in place."""
    slot = a[0:1]
    _slot_prefill(draft_params, dcache, config, slot, prompt, a[1:2])
    if dlen is not None:
        dlen.index_copy_(0, slot, a[2:3])


@torch.no_grad()
def draft_prefill_eager(draft_params: dict, config: ModelConfig, dcache: KVCache,
                        slot: int, prompt: torch.Tensor, *,
                        dlen: torch.Tensor | None = None,
                        prompt_len: int = 0) -> KVCache:
    """:func:`_draft_prefill`'s body run op by op, on any device."""
    device = dcache.k.device
    _draft_prefill_body(draft_params, config, dcache, dlen,
                        torch.as_tensor(prompt).to(device),
                        _draft_scalars(dcache, slot, prompt_len).to(device))
    return dcache


@torch.no_grad()
def _draft_prefill(draft_params: dict, config: ModelConfig, dcache: KVCache,
                   slot: int, prompt: torch.Tensor, *,
                   dlen: torch.Tensor | None = None, prompt_len: int = 0,
                   programs: _graphs.Programs | None = None) -> KVCache:
    """Prefill one slot of the draft cache on admission, in place (the
    draft twin of the engine's admit: the cache only, no tokens), and with
    ``dlen`` set the slot's draft length to ``prompt_len``.  The
    reference's jitted ``_draft_prefill`` as one CUDA-graph capture
    (:mod:`._graphs`) per prompt width, not ``torch.jit``: the slot and the
    length reach the graph as device scalars, so every slot replays it.
    On the CPU it runs the body."""
    prompt = torch.as_tensor(prompt)
    check_token_ids(prompt, config)
    _graphs.run(programs, "_draft_prefill",
                lambda p, a: _draft_prefill_body(draft_params, config, dcache, dlen, p, a),
                device=dcache.k.device, static=(config,),
                inputs=(prompt, _draft_scalars(dcache, slot, prompt_len)),
                bound=(draft_params, dcache, dlen), mutated=(dcache, dlen))
    return dcache


class SpecServingEngine(ServingEngine):
    """Speculative continuous batching: the slotted :class:`~.serving.ServingEngine`
    with a draft model (a leading-layer slice of the same parameters)
    proposing gamma tokens per tick and one ragged verify forward
    committing 1..gamma+1 tokens per slot per target stream.

    A subclass that replaces two hooks: ``_post_admit`` (prefill the draft
    cache beside every admission) and ``_decode_tick`` (the speculative
    tick instead of plain decode steps); admission, harvest, queueing,
    streaming and the run loop are the parent's.  Both hooks run compiled
    programs (:func:`_draft_prefill`, :func:`spec_tick`) through
    :meth:`_program`, on the engine's :attr:`programs`, as the parent's
    admissions do.  ``metrics["decode_steps"]`` counts target streams,
    ``metrics["drafted_accepted"]`` the tokens committed from the draft.
    Greedy only (the lossless guarantee; sampled speculation needs
    rejection sampling) and whole-bucket admission only (no chunked
    prefill, no prefix caching: mirroring them into the draft cache is
    future work).
    """

    def __init__(self, params: dict, config: ModelConfig, *, slots: int,
                 max_len: int, prompt_pad, draft_layers: int, gamma: int = 4,
                 eos_id: int = -1, on_tokens=None, tracer=None) -> None:
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        check_plain(config, "speculative decoding")
        self.gamma = gamma
        # buffer_margin: a slot at the logical max_len still needs a
        # non-clamping gamma+1 verify window (_write_kv_at's contract);
        # submissions stay bounded by the logical max_len.
        super().__init__(params, config, slots=slots, max_len=max_len,
                         prompt_pad=prompt_pad, eos_id=eos_id,
                         buffer_margin=gamma + 1, on_tokens=on_tokens, tracer=tracer)
        # Views of the engine's weights, the compute copy where it holds one.
        self.draft_params, self.draft_cfg = draft_slice(self.params, config, draft_layers)
        self._dcache = KVCache.create(self.draft_cfg, slots, max_len + gamma + 1,
                                      device=self.device)
        self._dlen = torch.zeros((slots,), dtype=torch.long, device=self.device)
        self.metrics["drafted_accepted"] = 0

    def submit(self, prompt, max_new: int, prefix: int | None = None) -> int:
        if prefix is not None:
            raise ValueError("prefix caching is not supported with "
                             "speculative serving (draft-cache mirroring "
                             "is future work)")
        return super().submit(prompt, max_new)

    def _program(self, name: str, *args, **kw):
        """The device program ``name``: this module's (``spec_tick``,
        ``_draft_prefill``) or the parent's, on :attr:`programs`."""
        if name not in SPEC_PROGRAMS:
            return super()._program(name, *args, **kw)
        return SPEC_PROGRAMS[name](*args, programs=self.programs, **kw)

    def _post_admit(self, slot: int, padded, prompt_len: int) -> None:
        self._run("_draft_prefill", {"slot": slot, "prompt_tokens": prompt_len,
                                     "first_pos": 0},
                  self.draft_params, self.draft_cfg, self._dcache, slot, _host(padded),
                  dlen=self._dlen, prompt_len=prompt_len)

    def _decode_tick(self) -> None:
        accepted = self._run("spec_tick", {"steps": 1}, self.params, self.draft_params,
                             self.state, self._dcache, self._dlen, self.config,
                             self.draft_cfg, self.eos_id, self.gamma)
        self.metrics["decode_steps"] += 1  # target streams paid
        self.metrics["drafted_accepted"] += int(self._read(accepted))


# The speculative engine's device programs by name, and their bodies run op
# by op (what an eager-driven twin of the engine calls instead).
SPEC_PROGRAMS = {"spec_tick": spec_tick, "_draft_prefill": _draft_prefill}
EAGER_PROGRAMS = {"spec_tick": spec_tick_eager, "_draft_prefill": draft_prefill_eager}
