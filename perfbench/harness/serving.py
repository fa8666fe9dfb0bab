"""What the two serving drivers share: the engine built from the cell's
settings, its warm-up, the window's loop, the records the metrics read, and
the check of what it served against the plain reference.

A request is timed on the host from when it was due (open loop) to the host
receiving its tokens through the engine's ``on_tokens`` stream.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np

from perfbench.harness import traffic
from perfbench.harness.common import log, percentile, sub_seed
from perfbench.harness.trace import host_range


@dataclass
class Served:
    req: traffic.Request
    sent: float | None = None     # host time of submit()
    first: float | None = None    # host time its first token arrived
    last: float | None = None
    tokens: list = field(default_factory=list)
    failed: bool = False
    base: int = 0                 # tokens it had when the window opened


def buckets_used(settings: dict, mix: dict) -> list[int]:
    """The prompt buckets the mix's lengths can land in."""
    lo, hi = mix["prompt"].get("min", 1), mix["prompt"]["max"]
    pads = sorted(settings["prompt_pad"])
    used = {next(b for b in pads if b >= n) for n in (lo, hi)}
    used.update(b for b in pads if lo <= b <= hi)
    return sorted(used)


def build(ctx):
    """The engine for the cell, with the stream wired to ``ctx.served``."""
    from perfbench.harness.port import engine_class

    s = ctx.cell["engine"]
    by_rid = ctx.by_rid

    def on_tokens(rid, toks):
        t = time.perf_counter()
        r = by_rid.get(rid)
        if r is None:          # a warm-up request
            return
        if r.first is None:
            r.first = t
        r.last = t
        r.tokens.extend(toks)

    return engine_class()(ctx.params, ctx.config, slots=s["slots"],
                          max_len=s["max_len"], prompt_pad=tuple(s["prompt_pad"]),
                          prefill_chunk=s.get("prefill_chunk"),
                          steps_per_tick=s.get("steps_per_tick", 1),
                          eos_id=-1, temperature=0.0, on_tokens=on_tokens)


def warm(ctx, engine) -> None:
    """Capture every program the cell's traffic will replay: one request
    per bucket it uses, as long as the bucket allows (a chunked bucket then
    runs its middle and its final chunk), two tokens each."""
    s, mix = ctx.cell["engine"], ctx.cell["traffic_mix"]
    rng = np.random.default_rng(sub_seed(ctx.seed, 9))
    for b in buckets_used(s, mix):
        n = min(b, mix["prompt"]["max"])
        engine.submit(rng.integers(0, ctx.model["vocab_size"], n), 2)
    engine.run()
    ctx.sync()


def fill(ctx, engine, reqs: list, n: int) -> list:
    """Set-up for a queue that never drains: submit the first ``n``
    requests and run the engine until each has its first token, so the
    window opens on full slots whose caches hold their prompts."""
    started = [Served(r) for r in reqs[:n]]
    for r in started:
        ctx.by_rid[engine.submit(r.req.prompt, r.req.max_new)] = r
        r.sent = time.perf_counter()
    while any(not r.tokens for r in started):
        engine.step()
    return started


def run_window(ctx, engine, reqs: list, backlog: int | None = None,
               started: list | None = None) -> dict:
    """Drive the engine for the window.  Open loop (``backlog`` None): each
    request is submitted once it is due.  Backlog: requests are submitted
    in order whenever fewer than ``backlog`` are in flight; ``started``
    are the first of them, submitted in set-up (:func:`fill`).  In a traced
    run the last ``trace_seconds`` of the window run under the profiler."""
    started = started or []
    for r in started:
        r.base = len(r.tokens)
    served = started + [Served(r) for r in reqs[len(started):]]
    ticks, queue = [], []
    stretch = ctx.stretch
    tail = ctx.cell.get("trace_seconds", 2.0)
    inflight, i, n = 0, len(started), len(reqs)
    late = 0.0
    t0 = time.perf_counter()
    end = t0 + ctx.seconds

    def submit(r: Served, now: float) -> None:
        nonlocal inflight, late
        try:
            with host_range("submit", ctx.trace):
                rid = engine.submit(r.req.prompt, r.req.max_new)
        except ValueError as e:
            r.failed = True
            log(f"refused request {r.req.index}: {e}")
            return
        r.sent = now
        if backlog is None:
            late = max(late, now - (t0 + r.req.due))
        ctx.by_rid[rid] = r
        inflight += 1

    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if stretch is not None and not stretch.running and now >= end - tail:
            stretch.start()
        inflight = sum(1 for r in served[:i]
                       if r.sent is not None and len(r.tokens) < r.req.max_new)
        if backlog is None:
            while i < n and t0 + reqs[i].due <= now:
                submit(served[i], now)
                i += 1
        else:
            while i < n and inflight < backlog:
                submit(served[i], now)
                i += 1
        queue.append((now - t0, len(getattr(engine, "_queue", ()))))
        if inflight:
            a = time.perf_counter()
            with host_range("engine.step", ctx.trace):
                engine.step()
            ticks.append((time.perf_counter() - a) * 1e3)
        else:
            nxt = t0 + reqs[i].due if i < n and backlog is None else end
            with host_range("wait", ctx.trace):
                time.sleep(max(0.0, min(nxt, end) - time.perf_counter()))
    t_stop = time.perf_counter()
    if stretch is not None and stretch.running:
        stretch.stop()
    window = t_stop - t0
    due = served if backlog is None else served[:i]
    ttft = [((r.first if r.first is not None else t_stop) - (t0 + r.req.due))
            for r in due] if backlog is None else []
    tpot = [(r.last - r.first) / (len(r.tokens) - 1) * 1e3
            for r in served if len(r.tokens) >= 2 and not r.base]
    done = [r for r in served if len(r.tokens) >= r.req.max_new]
    gen = sum(len(r.tokens) - r.base for r in served)
    log({"window_s": window, "submitted": sum(r.sent is not None for r in served),
         "due": len(due), "completed": len(done), "generated_tokens": gen,
         "in_flight_at_close": sum(1 for r in served if r.sent is not None
                                   and len(r.tokens) < r.req.max_new),
         "not_yet_submitted_due": sum(1 for r in due if r.sent is None),
         "generator_late_s": late,
         "offered_rate": len(due) / ctx.seconds if backlog is None else None,
         "completed_rate": len(done) / window,
         "ttft_p50_s": percentile(ttft, 0.5), "tpot_p50_ms": percentile(tpot, 0.5),
         "ticks": len(ticks), "tick_ms_mean": sum(ticks) / max(1, len(ticks))})
    return {"served": served, "due": due, "window_s": window, "ticks": ticks,
            "ttft": ttft, "tpot": tpot, "done": done, "generated": gen, "queue": queue,
            "failed": sum(r.failed for r in served)}


def record(ctx, out: dict) -> dict:
    """What the per-layer readers read from a traced serving run."""
    rec = {"window_s": out["window_s"], "tick_ms": out["ticks"],
           "requests": [{"prompt_len": len(r.req.prompt), "generated": len(r.tokens),
                         "before_window": r.base}
                        for r in out["served"] if r.sent is not None]}
    if ctx.engine_trace is not None:
        m = ctx.engine_trace.marks
        rec["programs"] = [{"name": p.name, "ms": m.ms(p.start, p.end),
                            "prompt_tokens": p.prompt_tokens, "first_pos": p.first_pos,
                            "steps": p.steps} for p in ctx.engine_trace.programs]
    return rec


def free(ctx, engine) -> None:
    """Let go of the engine (cache, graphs, pool) before the reference runs."""
    engine.trace = None
    engine.programs.release()
    engine.programs = engine.state = None
    gc.collect()
    ctx.empty_cache()


def choose(seed: int, done: list, check_cfg: dict) -> list:
    """The requests compared: drawn from the seed among the finished ones,
    the longest (prompt and answer) first, until ``served_tokens`` served
    tokens or ``max_requests`` requests."""
    if not done:
        return []
    rng = np.random.default_rng(sub_seed(seed, 4))
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.tokens))
    rest = [done[j] for j in rng.permutation(len(done)) if done[j] is not longest]
    sample, tokens = [], 0
    for r in [longest] + rest:
        if tokens >= check_cfg["served_tokens"] or len(sample) >= check_cfg["max_requests"]:
            break
        sample.append(r)
        tokens += len(r.tokens)
    return sample


def gaps(params: dict, model: dict, sample: list, device, control: bool = False) -> dict:
    """For each position that picked a served token: how far the served
    token's reference logit lies below the reference's best.  With
    ``control``, also how far below it lies the token the control (the
    reference in float8) puts first at the same position."""
    from perfbench.reference import model as ref

    out = {"served_gap": 0.0, "compared_tokens": 0, "compared_requests": len(sample)}
    if control:
        out["control_gap"] = 0.0
    if not sample:
        out["served_gap"] = float("inf")
        return out
    with ref.strict_float32():
        for r in sample:
            seq, want, picked = sequence(r.req.prompt, r.tokens, device)
            logits = ref.logits_at(params, seq, model, want)
            best = logits.max(-1).values
            gap = best - logits.gather(1, picked[:, None])[:, 0]
            out["served_gap"] = max(out["served_gap"], float(gap.max()))
            out["compared_tokens"] += len(r.tokens)
            if control:
                low = ref.logits_at(params, seq, model, want, low=True).argmax(-1)
                cgap = best - logits.gather(1, low[:, None])[:, 0]
                out["control_gap"] = max(out["control_gap"], float(cgap.max()))
            del logits
    return out


def check(ctx, done: list, check_cfg: dict) -> dict:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, over a sample drawn from the seed of
    the finished requests, the longest among them."""
    return gaps(ctx.params, ctx.model, choose(ctx.seed, done, check_cfg), ctx.device)


def sequence(prompt, served, device):
    """(prompt + served tokens but the last, the positions whose logits
    picked each served token, the served tokens) as device tensors."""
    import torch

    P = len(prompt)
    seq = torch.as_tensor(np.concatenate([np.asarray(prompt), np.asarray(served[:-1],
                                                                          dtype=np.int64)]),
                          dtype=torch.long, device=device)
    want = torch.arange(P - 1, P - 1 + len(served), device=device)
    picked = torch.as_tensor(served, dtype=torch.long, device=device)
    return seq, want, picked


def end_to_end(out: dict) -> dict:
    return {"ttft_p90_s": percentile(out["ttft"], 0.9),
            "tpot_p90_ms": percentile(out["tpot"], 0.9),
            "gen_tokens_per_s": out["generated"] / out["window_s"]}
