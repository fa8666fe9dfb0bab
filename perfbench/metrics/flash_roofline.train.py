"""The three flash kernels' least time over their measured device time, in
the profiled stretch: sum of each launch's bound from the cell's shapes
over the sum of the kernels' times.  The bound counts the work the
attention needs, whatever kernel does it (a frozen copy of
``chip_smoke.flash_bound_ms``): the causal pairs, 2 flops per multiply-add
per head-dim element in each product, and each [B, S, N, H] operand read or
written once, against the bf16 peak and the HBM bandwidth."""

from perfbench.harness.readers import PEAK_BF16_FLOPS, PEAK_BYTES

# kernel name fragment -> (products, [B, S, N, H] tensors moved, f32 values a row)
KINDS = {"flash_fwd": (2, 4, 1), "flash_dq": (3, 5, 2), "flash_dkv": (4, 6, 2)}


def flops_bytes(B, S, N, H, products, n_io, n_rows, elem=2, causal=True):
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2.0 * products * B * N * pairs * H
    nbytes = n_io * B * S * N * H * elem + 4.0 * n_rows * B * N * S
    return flops, nbytes


def bound_s(B, S, N, H, products, n_io, n_rows) -> float:
    flops, nbytes = flops_bytes(B, S, N, H, products, n_io, n_rows)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    m = rec["model"]
    need = took = 0.0
    for name, (count, seconds) in prof["kernels"].items():
        for frag, shape in KINDS.items():
            if frag in name:
                need += count * bound_s(rec["batch"], rec["seq"], m["num_attention_heads"],
                                        m["head_dim"], *shape)
                took += seconds
    return 100.0 * need / took if took else None
