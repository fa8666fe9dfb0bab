"""Model flops served in the window over the window's seconds at the bf16
peak: 2 x (the parameters a token multiplies through) per prompt token
admitted and per decode step's token, plus attention over the positions
each token attends (its own and the earlier ones)."""

from perfbench.harness.readers import (ADMISSIONS, PEAK_BF16_FLOPS,
                                       attention_flops_per_pair, matmul_params, programs)


def decode_steps(plen: int, generated: int, before: int) -> tuple[int, int]:
    """(first position fed, steps) of a request's decode steps in the
    window: the first token comes from the prefill, token j >= 2 from the
    step that feeds position plen + j - 2, and the window made tokens
    before + 1 .. generated."""
    j0 = max(2, before + 1)
    return plen + j0 - 2, max(0, generated - j0 + 1)


def window_flops(m: dict, admissions: list, steps: list) -> float:
    """``admissions``: (first position, prompt tokens) per admission call;
    ``steps``: (first position fed, decode steps) per request."""
    per_tok, per_pair = 2.0 * matmul_params(m), attention_flops_per_pair(m)
    total = 0.0
    for first, n in admissions + steps:
        # n tokens at positions first .. first + n - 1, each attending itself
        # and every earlier position
        total += n * per_tok + per_pair * (n * first + n * (n + 1) / 2)
    return total


def read(rec):
    adm = [(p["first_pos"], p["prompt_tokens"]) for p in programs(rec, *ADMISSIONS)
           if p["prompt_tokens"] is not None and p["first_pos"] is not None]
    if not adm or not rec.get("window_s"):
        return None
    steps = [decode_steps(r["prompt_len"], r["generated"], r.get("before_window", 0))
             for r in rec["requests"]]
    return 100.0 * window_flops(rec["model"], adm, steps) / (rec["window_s"] * PEAK_BF16_FLOPS)
