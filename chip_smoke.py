#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tputopo_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with one GPU, ``nvcc``
and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every kernel of the port compiled from ``tputopo_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at tiny
   shapes and at the main path's shape, with its stated tolerance, and
   timed beside the plain version and one PyTorch library call;
4. the inference forward of Llama-3-8B at full width (32 layers, random
   weights from a seed) on 2048 tokens: ``attn_impl="auto"`` must launch
   the flash kernel once per layer, the logits must be finite and agree
   with the einsum path within a stated bound;
5. greedy KV-cache decoding at full width, twice, with identical tokens.

Then one ``kernels`` line, the card's ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Without a GPU, or without the repository beside it,
the script fails.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent

# The reference paths compare in full f32: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published dense peaks of one H100 SXM at its full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel against plain version.  f32: the same products in f32, summed in
# another order -> the reference's own flash tolerance (3e-5).  bf16: both
# sides round P and O to bf16, the kernel relative to a running tile max,
# the plain version relative to the row max, so an element may differ by
# about two bf16 ulps at its magnitude.  The LSE is f32 on both sides.
TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (1.6e-2, 1.6e-2)}
LSE_TOL = 1e-4

# Forward with the kernel against the einsum path, bf16, 32 layers: the
# einsum path rounds the scores and probabilities to bf16, the kernel keeps
# scores in f32, and the difference compounds over depth.  A CPU run of
# the port at d_model 512, 32 layers, vocab 128256 gave max |dlogit| 0.14
# and top-1 agreement 0.955; the bounds leave room for the wider model.
FWD_MAX_ABS = 0.5
FWD_TOP1 = 0.9
# Greedy decode against the kernel forward over the same tokens.  Two bf16
# computations of the logits that differ by at most D elementwise put the
# argmax of one within 2 D of the other's max; D is held to FWD_MAX_ABS.
# Random weights give nearly flat logits (top-1 gaps ~0.1), so the top-1
# rate is reported, not bounded; a pick that were not greedy would sit
# several units below the max.
GEN_GAP = 2 * FWD_MAX_ABS
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound_ms(B, S, N, H, dtype, causal) -> tuple[float, str]:
    """Least time for the attention forward: causal pairs actually needed,
    2 matmuls of 2 flops per pair per head-dim element; each of q, k, v
    read once and o, lse written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * N * pairs * H
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4.0 * B * S * N * H * elem + 4.0 * B * N * S
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_flash(att, kernel) -> dict:
    """The flash forward kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (B, S, N, H, dtype, causal, block_q, block_kv): both dtypes, causal
    # and not, uneven blocks, S not a multiple of the kernel's 64-row tile,
    # H not a multiple of 16, and the model's shape.
    cases = [
        (2, 64, 2, 16, torch.float32, True, 16, 16),
        (2, 64, 2, 16, torch.float32, False, 16, 16),
        (1, 64, 1, 8, torch.float32, False, 16, 32),
        (1, 200, 2, 128, torch.float32, True, 8, 8),
        (2, 96, 3, 32, torch.bfloat16, True, 32, 32),
        (1, 40, 2, 24, torch.bfloat16, False, 8, 20),
        (1, 2048, 32, 128, torch.bfloat16, True, 128, 128),
    ]
    main_err = 0.0
    for B, S, N, H, dtype, causal, bq, bkv in cases:
        q, k, v = (torch.randn((B, S, N, H), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        o, lse = att.flash_forward_lse(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
        po, plse = att._flash_forward_lse_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs()
        atol, rtol = TOL[dtype]
        ok = bool((err <= atol + rtol * po.float().abs()).all())
        lse_err = (lse - plse).abs().max().item()
        rec = {"phase": "flash_vs_plain", "shape": [B, S, N, H],
               "dtype": str(dtype).removeprefix("torch."), "causal": causal,
               "blocks": [bq, bkv], "max_abs_err": err.max().item(),
               "atol": atol, "rtol": rtol, "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL, "within": ok and lse_err <= LSE_TOL}
        emit(rec)
        check(rec["within"], f"flash kernel disagrees with its plain version: {rec}")
        check(bool(torch.isfinite(o.float()).all()), "flash kernel output not finite")
        main_err = err.max().item()  # the last case is the main path's shape

    B, S, N, H = 1, 2048, 32, 128
    q, k, v = (torch.randn((B, S, N, H), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    kernel_ms = cuda_ms(lambda: att.flash_forward_lse(q, k, v, causal=True,
                                                      block_q=128, block_kv=128))
    plain_ms = cuda_ms(lambda: att._flash_forward_lse_plain(q, k, v, causal=True), reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    bound_ms, bound_by = flash_bound_ms(B, S, N, H, torch.bfloat16, True)
    rec = {"phase": "flash_timing", "shape": [B, S, N, H], "dtype": "bfloat16",
           "causal": True, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "scaled_dot_product_attention",
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    return {"name": kernel.name, "route": "cuda",
            "source": kernel.source.relative_to(REPO).as_posix(),
            "replaces": "tputopo/workloads/attention.py:118",
            "max_abs_err": main_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_forward(tt, kernels) -> tuple:
    """Llama-3-8B inference forward at full width, 2048 tokens.  Returns
    (params, config, tokens, flash launches of the counted forward)."""
    from tputopo_torch.model import _use_flash

    cfg = tt.ModelConfig.llama3_8b()
    t0 = time.perf_counter()
    params = tt.init_params(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    S = 2048
    tokens = torch.randint(0, cfg.vocab_size, (1, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    check(_use_flash(cfg, S, tokens.device), "attn_impl=auto did not pick the kernel")
    tt.forward(params, tokens, cfg)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    logits = tt.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    check(launches["flash_fwd"] == cfg.n_layers,
          f"forward launched flash_fwd {launches['flash_fwd']} times, "
          f"want {cfg.n_layers}")
    check(tuple(logits.shape) == (1, S, cfg.vocab_size), f"logits shape {logits.shape}")
    check(logits.dtype == torch.float32, f"logits dtype {logits.dtype}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")

    ecfg = dataclasses.replace(cfg, attn_impl="einsum")
    ref = tt.forward(params, tokens, ecfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = tt.forward(params, tokens, ecfg)
    torch.cuda.synchronize()
    einsum_s = time.perf_counter() - t0
    max_abs = (logits - ref).abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    rec = {"phase": "forward", "model": "llama3_8b", "layers": cfg.n_layers,
           "tokens": [1, S], "init_s": init_s, "forward_s": fwd_s,
           "einsum_forward_s": einsum_s, "launches": launches,
           "logit_absmax": logits.abs().max().item(),
           "vs_einsum_max_abs": max_abs, "vs_einsum_top1": top1,
           "bound_max_abs": FWD_MAX_ABS, "bound_top1": FWD_TOP1,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    check(max_abs <= FWD_MAX_ABS and top1 >= FWD_TOP1,
          f"kernel forward disagrees with the einsum path: {rec}")
    return params, cfg, tokens, launches


def phase_generate(tt, kernels, params, cfg) -> torch.Tensor:
    """Greedy KV-cache decode at full width, twice; returns the prompt."""
    B, P, new = GEN_BATCH, GEN_PROMPT, GEN_NEW
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    runs = []
    for _ in range(2):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = tt.generate(params, prompt, cfg, max_new=new)
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0))
    (a, _), (b, dt) = runs
    check(tuple(a.shape) == (B, P + new), f"generate shape {tuple(a.shape)}")
    check(bool(((a >= 0) & (a < cfg.vocab_size)).all()), "generated ids out of range")
    check(bool(torch.equal(a[:, :P], prompt)), "generate changed the prompt")
    check(bool(torch.equal(a, b)), "greedy generate is not deterministic")
    gen_launches = {k.name: k.launches for k in kernels}
    # The cached path against the whole forward over the generated tokens.
    full = tt.forward(params, a[:, :-1], cfg)[:, P - 1:]
    picks = a[:, P:]
    top1 = (full.argmax(-1) == picks).float().mean().item()
    gap = (full.amax(-1) - full.gather(-1, picks[..., None])[..., 0]).max().item()
    emit({"phase": "generate", "model": "llama3_8b", "batch": B, "prompt": P,
          "max_new": new, "wall_s": dt, "new_tokens_per_s": B * new / dt,
          "launches": gen_launches, "identical_runs": True,
          "vs_forward_top1": top1, "vs_forward_max_gap": gap,
          "bound_max_gap": GEN_GAP})
    check(gap <= GEN_GAP, f"a generated token is not the forward's greedy pick: "
                          f"logit gap {gap} > {GEN_GAP}")
    return prompt


def device_profile(path: str, fn, top: int = 12) -> dict:
    """Device time by kernel over one run of ``fn``, from torch.profiler.
    The wall time includes the profiler's own overhead, so the idle share
    it gives is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their device time is their kernels'
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"phase": "profile", "path": path, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"kernel": key[:100], "calls": n, "ms": ms}
                    for ms, n, key in rows[:top]]}


def main() -> int:
    check(torch.cuda.is_available(), "no CUDA device")
    import tputopo_torch as tt
    from tputopo_torch import _kernels, attention as att

    name = card()
    emit({"phase": "card", "nvidia_smi": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    for k in _kernels.KERNELS:
        k.lib()
        emit({"phase": "build", "kernel": k.name, "seconds": k.build_seconds,
              "library": k.library_path().name})
        print(k.build_log, file=sys.stderr, flush=True)

    entry = phase_flash(att, _kernels.FLASH_FWD)
    params, cfg, tokens, launches = phase_forward(tt, _kernels.KERNELS)
    prompt = phase_generate(tt, _kernels.KERNELS, params, cfg)
    emit(device_profile("forward", lambda: tt.forward(params, tokens, cfg)))
    emit(device_profile("generate", lambda: tt.generate(
        params, prompt, cfg, max_new=GEN_NEW)))
    entry["launches"] = launches[entry["name"]]
    emit({"kernels": [entry]})
    print(name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
