"""Model flops of the window's steps over the window's seconds at the bf16
peak: per step 6 x (the parameters a token multiplies through) x tokens,
plus attention over the causal pairs only (forward and backward, 3 x the
forward's 4 flops a pair and head dim); remat's recomputation not
counted."""

from perfbench.harness.readers import (PEAK_BF16_FLOPS, attention_flops_per_pair,
                                       matmul_params)


def step_flops(m: dict, batch: int, seq: int) -> float:
    pairs = seq * (seq + 1) / 2
    return (6.0 * matmul_params(m) * batch * seq
            + 3.0 * attention_flops_per_pair(m) * batch * pairs)


def read(rec):
    if not rec.get("steps") or not rec.get("window_s"):
        return None
    flops = rec["steps"] * step_flops(rec["model"], rec["batch"], rec["seq"])
    return 100.0 * flops / (rec["window_s"] * PEAK_BF16_FLOPS)
