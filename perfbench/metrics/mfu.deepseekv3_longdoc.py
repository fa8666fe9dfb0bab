"""Model flops served in the window over the window's seconds at the bf16
peak: per prompt token admitted and per decode step's token, 2 x the
parameters it multiplies through (the held experts' share of its routed
pairs) plus each head's attention over the positions it attends (its own
and the earlier ones), DeepSeek's widths (:mod:`perfbench.harness.latent`).
The admissions are the benchmark's program spans of the window; the decode
steps are counted from each request's tokens."""

from perfbench.harness.latent import pair_flops, token_flops
from perfbench.harness.readers import ADMISSIONS, PEAK_BF16_FLOPS, programs


def decode_steps(plen: int, generated: int, before: int) -> tuple[int, int]:
    """(first position fed, steps) of a request's decode steps in the
    window: the first token comes from the prefill, token j >= 2 from the
    step that feeds position plen + j - 2, and the window made tokens
    before + 1 .. generated."""
    j0 = max(2, before + 1)
    return plen + j0 - 2, max(0, generated - j0 + 1)


def window_flops(m: dict, calls: list) -> float:
    """``calls``: (first position, tokens) of each admission and of each
    request's decode steps."""
    per_tok, per_pair = token_flops(m), pair_flops(m)
    return sum(n * per_tok + per_pair * (n * first + n * (n + 1) / 2)
               for first, n in calls)


def read(rec):
    adm = [(p["first_pos"], p["prompt_tokens"]) for p in programs(rec, *ADMISSIONS)
           if p["prompt_tokens"] is not None and p["first_pos"] is not None]
    if not adm or not rec.get("window_s"):
        return None
    steps = [decode_steps(r["prompt_len"], r["generated"], r.get("before_window", 0))
             for r in rec["requests"]]
    return 100.0 * window_flops(rec["model"], adm + steps) / (rec["window_s"] * PEAK_BF16_FLOPS)
