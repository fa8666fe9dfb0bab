"""The grouped expert GEMMs' least time over their measured device time, in
the profiled stretch.  The least time is that of the work the routed
expert layer's three products need over the stretch, whatever kernel does
it: 6 D F flops a routed (token, expert) pair, and the bf16 tables of each
expert a call routes a pair to read once a call, with the pairs' rows in
and out of each product (2 B a value: D in and F out of the gate and the
up product, F in and D out of the down product), against the bf16 peak
and the HBM bandwidth.  The counts are the program's (``moe.pairs`` and
``moe.experts_hit``, their growth between the stretch's start and stop);
the measured time is the device trace's, of the kernels ``torch._grouped_mm``
runs.  Summed over the stretch's calls, the larger of the two times is a
call's whenever every call is bound by the same one: here every call is
bound by its bytes (a call's flops per byte are about its pairs per hit
expert, a few dozen in this cell, where a 128-token chunk routes 256 pairs
over 8 experts: far below the card's 295)."""

from perfbench.harness.readers import PEAK_BF16_FLOPS, PEAK_BYTES

# Name fragments of the device kernels of one torch._grouped_mm call
# (PyTorch's CUTLASS grouped GEMM and the kernel that sets up its groups).
KERNELS = ("GroupProblemShape", "grouped_gemm", "grouped_mm")


def flops_bytes(m: dict, pairs: int, experts_hit: int) -> tuple[float, float]:
    D, F = m["hidden_size"], m["intermediate_size"]
    flops = 6.0 * D * F * pairs
    nbytes = 2.0 * (3 * D * F * experts_hit + (3 * D + 3 * F) * pairs)
    return flops, nbytes


def bound_s(m: dict, pairs: int, experts_hit: int) -> float:
    flops, nbytes = flops_bytes(m, pairs, experts_hit)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def grouped_seconds(kernels: dict) -> float:
    return sum(s for name, (_, s) in kernels.items()
               if any(f in name for f in KERNELS))


def read(rec):
    prof = rec.get("profile")
    marks = rec.get("stretch_counts") or {}
    a = (marks.get("start") or {}).get("moe")
    b = (marks.get("stop") or {}).get("moe")
    if not prof or not a or not b:
        return None
    pairs, hit = b["pairs"] - a["pairs"], b["experts_hit"] - a["experts_hit"]
    took = grouped_seconds(prof["kernels"])
    if not took or not pairs:
        return None
    return 100.0 * bound_s(rec["model"], pairs, hit) / took
