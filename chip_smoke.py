#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tputopo_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with one GPU, ``nvcc``
and a CUDA build of PyTorch:

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every kernel of the port compiled from ``tputopo_torch/csrc``,
   one ``nvcc`` per source, all at once, with ptxas' register and spill
   counts;
3. each kernel against its plain PyTorch version on the card, at tiny
   shapes and at the main path's shape, with its stated tolerance, and
   timed beside the plain version and one PyTorch library call: the flash
   forward, then the dQ and dK/dV backward kernels;
4. the inference forward of Llama-3-8B at full width (32 layers, random
   weights from a seed) on 2048 tokens: ``attn_impl="auto"`` must launch
   the flash kernel once per layer, the logits must be finite and agree
   with the einsum path within a stated bound;
5. greedy KV-cache decoding at full width, twice, with identical tokens;
6. serving at full width, 32 layers: the continuous-batching engine (8
   slots, chunked prefill, one shared prefix, streaming) over a seeded
   stream of 24 requests, twice with identical tokens, every greedy pick
   held against the whole forward and no flash launch; then the same
   stream with int8 weights and an int8 KV cache, and a few requests with
   grouped int4 weights at 4 layers (below), each against its own tree's
   forward;
7. training at Llama-3-8B width, depth cut to 4 layers (below): loss and
   grads through the kernels against the einsum path, then three AdamW
   steps on one batch, each launching the forward kernel 2·L times and
   each backward kernel L times, with the loss falling; then one
   loss-and-grads under each remat policy.

Then the seconds of each phase, one ``kernels`` line, the card's
``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Without a GPU, or without the repository beside it,
the script fails.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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

# Serving: the continuous-batching engine over the same 32-layer weights, 8
# slots over a 2048-row cache, prefill buckets 128/512/1024, greedy and with
# no EOS (random weights make any EOS id arbitrary).  The wider buckets
# prefill in chunks of 128: the engine, as the reference's, needs the chunk
# to divide every bucket, so 256 would refuse the 128 bucket.
SERVE_ENGINE = dict(slots=8, max_len=2048, prompt_pad=(128, 512, 1024),
                    prefill_chunk=128, eos_id=-1)
# The stream: 24 requests, prompt lengths uniform in 16-1000 and max_new in
# 8-48 from a seeded generator, every third request behind one registered
# 256-token prefix (its prompt is then the suffix), all submitted at once.
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_PREFIX = 24, (16, 1000), (8, 48), 256
# The profiled window: ticks of an engine serving the whole stream, after
# the first ticks have filled its slots.  A whole run traces ~4,500 events a
# tick, whose post-processing took minutes on the card's host (~4 s a tick).
SERVE_WARM_TICKS, SERVE_PROFILED_TICKS = 8, 5
# int8 weights and an int8 KV cache, each pick against the int8 tree's own
# forward, whose K/V are never quantized.  Besides the bf16 difference of the
# two computations (GEN_GAP), the cache rounds every K and V row to 1/254 of
# its absmax, which moves each attention logit and output by up to ~0.4% of
# the row's magnitude per layer, compounded over 32 layers; the bound doubles
# GEN_GAP for it.  These phases run on the CPU at d_model 512, 32 layers,
# vocab 128256 and a 6-request stream gave max gap 0.038 (top-1 0.973) here,
# 0.0 with the bf16 cache; the bound is for the wider model and the longer
# stream.
SERVE_INT8_GAP = 2 * GEN_GAP
SERVE_INT8_BYTE_RATIO = 0.55  # the reference's bound (tests/test_quant.py)
# Grouped int4 (group 128) at full width, depth cut to 4 layers for the run's
# time only: the plain unpack-per-call int4 matmul rebuilds an f32 copy of
# each weight on every call.  Four short requests, two behind the prefix, so
# the check's forwards stay small: their f32 group partials of the int4 head
# are [tokens, 32, 128256].  Its KV cache is bf16: GEN_GAP holds.
SERVE_INT4_LAYERS, SERVE_INT4_GROUP = 4, 128
SERVE_INT4_REQUESTS, SERVE_INT4_PROMPT, SERVE_INT4_NEW = 4, (16, 512), (8, 16)

# Backward kernels against their plain versions.  f32: the reference's grad
# tolerance (tests/test_attention.py:90), elementwise.  bf16, as
# ||kernel - plain|| / ||plain|| per output: both sides compute P and dS in
# f32 from the same f32 scores and round them to bf16 before the products,
# so they differ only where two f32 values summed in another order round
# to neighbouring bf16 numbers (2**-8 relative), and in the final rounding
# of dQ, dK and dV to bf16 (at most one ulp, 2**-8 relative).  Each output
# element is off by at most ~one ulp, so the norm-relative error stays under
# 2**-8 = 3.9e-3; the bound is 2.5x that.  An elementwise bound would trip
# on the outputs that cancel to near zero over 2048 terms.
BWD_F32_TOL = 5e-5
BWD_BF16_NORM_REL = 1e-2

# The forward and backward kernels' cases: both dtypes, causal and not,
# uneven blocks, S not a multiple of the kernels' tiles (64 rows for f32;
# 128 and 64 for bf16, where a ragged tail lands inside a 128-row tile),
# H not a multiple of 16, H = 64 (one 64-column box) and H = 128 (two),
# S = 320 (five 64-row tiles, an odd count for a two-stage ring, and a
# ragged third 128-row tile whose two halves see different tile counts
# under the causal mask), and the model's shape (last).
# (B, S, N, H, dtype, causal, block_q, block_kv)
FLASH_CASES = [
    (2, 64, 2, 16, torch.float32, True, 16, 16),
    (2, 64, 2, 16, torch.float32, False, 16, 16),
    (1, 64, 1, 8, torch.float32, False, 16, 32),
    (1, 200, 2, 128, torch.float32, True, 8, 8),
    (2, 96, 3, 32, torch.bfloat16, True, 32, 32),
    (1, 40, 2, 24, torch.bfloat16, False, 8, 20),
    (1, 200, 2, 128, torch.bfloat16, True, 8, 8),
    (2, 192, 2, 64, torch.bfloat16, True, 64, 64),
    (1, 256, 2, 128, torch.bfloat16, False, 128, 128),
    (1, 320, 2, 128, torch.bfloat16, True, 64, 64),
    (1, 320, 2, 128, torch.bfloat16, False, 64, 64),
    (1, 2048, 32, 128, torch.bfloat16, True, 128, 128),
]

# Training: Llama-3-8B at full width (vocab 128256, d_model 4096, 32/8
# heads, head dim 128, d_ff 14336), remat="block", bf16 over f32 masters,
# tokens [1, 2048].  Depth is cut to 4 layers, and only for memory: each
# parameter costs 16 B (f32 master, f32 grad, two f32 AdamW moments), so
# 32 layers (8.03 B parameters) would need 128 GB, above the card's 80 GB;
# 4 layers are 1.92 B parameters, ~31 GB of state.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_LR, TRAIN_STEPS = 4, 2048, 3e-4, 3
# One step's loss and grads through the kernels against the einsum path,
# bf16: the einsum path rounds the scores and probabilities to bf16, the
# kernels keep scores in f32, and the difference compounds through the
# layers and into every grad.  A CPU run of the port at d_model 512, 4
# layers, vocab 128256, 512 tokens gave |dloss| 2.4e-4 and per-leaf
# ||dgrad|| / ||grad|| 0.010-0.024; the bounds leave room for the wider
# model and the longer sequence.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_NORM_REL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time of one call: ``launches`` calls back to back between one
    pair of CUDA events, divided by ``launches``; the median of ``reps``
    such runs.  Back to back, the host's work for one call (argument
    checks, allocation, the ctypes call) overlaps the device's work for the
    calls before it, so what is timed is the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def flash_bound_ms(B, S, N, H, dtype, causal, products=2, n_io=4,
                   n_rows=1) -> tuple[float, str]:
    """Least time for an attention kernel: the causal pairs actually needed,
    ``products`` matmuls of 2 flops per pair per head-dim element (2 for
    the forward, 3 for dQ, 4 for dK/dV); ``n_io`` [B, S, N, H] tensors
    read or written once (4 for the forward: q, k, v, o; 5 for dQ; 6 for
    dK/dV) and ``n_rows`` f32 values per row (the LSE; the backward's LSE
    and D)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2.0 * products * B * N * pairs * H
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = n_io * B * S * N * H * elem + 4.0 * n_rows * B * N * S
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# The first template argument of each entry function at H = 128: 16-column
# chunks for the f32 bodies, 64-column TMA boxes for the wgmma bodies.
H128_ARG = {"f32": "8", "sm90": "2"}


def ptxas_summary(log: str) -> dict:
    """Registers and spills of each H = 128 entry function, from ptxas -v.
    The wgmma bodies' count is ptxas' cap from their launch bounds; their
    consumer warpgroups raise it to 240 at run time (setmaxnreg)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'\S*?\d(flash_(?:fwd|dq|dkv)_(f32|sm90))ILi(\d)E", line)
            name = m.group(1) if m and m.group(3) == H128_ARG[m.group(2)] else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def card(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, power draw and temperature, sampled beside a window."""
    return card("clocks.sm,power.draw,temperature.gpu")


def phase_flash(att, kernel) -> dict:
    """The flash forward kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = 0.0
    for B, S, N, H, dtype, causal, bq, bkv in FLASH_CASES:
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
    kernel_ms = cuda_ms(lambda: att._flash_forward_lse_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: att._flash_forward_lse_plain(q, k, v, causal=True))
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


def phase_flash_bwd(att) -> list[dict]:
    """The dQ and dK/dV kernels against their plain versions on the same
    q, k, v, dO, LSE and D, then timed at the model's shape."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {}
    for B, S, N, H, dtype, causal, bq, bkv in FLASH_CASES:
        q, k, v, do = (torch.randn((B, S, N, H), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = att.flash_forward_lse(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
        got = att.flash_backward(q, k, v, o, lse, do, causal=causal, block_q=bq,
                                 block_kv=bkv)
        d = att._flash_d(o, do)
        plain = (att._flash_dq_plain(q, k, v, do, lse, d, causal=causal),
                 *att._flash_dkv_plain(q, k, v, do, lse, d, causal=causal))
        torch.cuda.synchronize()
        rec = {"phase": "flash_bwd_vs_plain", "shape": [B, S, N, H],
               "dtype": str(dtype).removeprefix("torch."), "causal": causal,
               "blocks": [bq, bkv]}
        ok = True
        for name, g, ref in zip(("dq", "dk", "dv"), got, plain):
            g, ref = g.float(), ref.float()
            check(bool(torch.isfinite(g).all()), f"{name} kernel output not finite")
            err = (g - ref).abs()
            norm_rel = ((g - ref).norm() / ref.norm()).item()
            rec[f"{name}_max_abs_err"] = err.max().item()
            rec[f"{name}_norm_rel_err"] = norm_rel
            if dtype == torch.float32:
                ok &= bool((err <= BWD_F32_TOL + BWD_F32_TOL * ref.abs()).all())
            else:
                ok &= norm_rel <= BWD_BF16_NORM_REL
            errs[name] = err.max().item()  # the last case is the model's shape
        rec["tolerance"] = ({"atol": BWD_F32_TOL, "rtol": BWD_F32_TOL}
                            if dtype == torch.float32 else {"norm_rel": BWD_BF16_NORM_REL})
        rec["within"] = ok
        emit(rec)
        check(ok, f"backward kernels disagree with their plain versions: {rec}")

    B, S, N, H = 1, 2048, 32, 128
    q, k, v, do = (torch.randn((B, S, N, H), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=128, block_kv=128)
    d = att._flash_d(o, do)
    args = (q, k, v, do, lse, d)
    times = {
        "dq": (cuda_ms(lambda: att._flash_dq_cuda(*args, causal=True)),
               cuda_ms(lambda: att._flash_dq_plain(*args, causal=True))),
        "dkv": (cuda_ms(lambda: att._flash_dkv_cuda(*args, causal=True)),
                cuda_ms(lambda: att._flash_dkv_plain(*args, causal=True))),
    }
    # The yardstick: SDPA's backward, which computes dQ, dK and dV together.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt),
                                                     do.transpose(1, 2),
                                                     retain_graph=True))
    entries = []
    for name, kernel_name, line, products, n_io, err in (
            ("dq", "flash_bwd_dq", 170, 3, 5, errs["dq"]),
            ("dkv", "flash_bwd_dkv", 200, 4, 6, max(errs["dk"], errs["dv"]))):
        bound_ms, bound_by = flash_bound_ms(B, S, N, H, torch.bfloat16, True,
                                            products=products, n_io=n_io, n_rows=2)
        kernel_ms, plain_ms = times[name]
        emit({"phase": "flash_bwd_timing", "kernel": kernel_name,
              "shape": [B, S, N, H], "dtype": "bfloat16", "causal": True,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library": "scaled_dot_product_attention backward (dQ, dK, dV)",
              "bound_ms": bound_ms, "bound_by": bound_by})
        entries.append({"name": kernel_name, "route": "cuda",
                        "source": f"tputopo_torch/csrc/{kernel_name}.cu",
                        "replaces": f"tputopo/workloads/attention.py:{line}",
                        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
    return entries


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


def serve_stream(vocab: int, seed: int, n: int, prompt: tuple, new: tuple,
                 every: int) -> tuple:
    """A seeded request stream: (prefix, [(prompt, max_new, behind the
    prefix?), ...]); request i goes behind the prefix when i % every == 0."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    reqs = []
    for i in range(n):
        plen, m = int(rng.integers(prompt[0], prompt[1] + 1)), int(rng.integers(new[0], new[1] + 1))
        reqs.append((rng.integers(0, vocab, plen).tolist(), m, i % every == 0))
    return prefix, reqs


def run_engine(tt, params, cfg, prefix, reqs) -> dict:
    """One engine serving the stream, every request submitted at once;
    the host clock from before the prefix's registration to the drained
    queue.  Time to first token is, per request, from its submit to the
    streaming callback's first call for it."""
    first: dict[int, float] = {}

    def on_tokens(rid, toks):
        first.setdefault(rid, time.perf_counter())

    eng = tt.ServingEngine(params, cfg, on_tokens=on_tokens, **SERVE_ENGINE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = eng.register_prefix(prefix)
    ids, submitted = [], {}
    for p, m, behind in reqs:
        rid = eng.submit(p, max_new=m, prefix=pid if behind else None)
        submitted[rid] = time.perf_counter()
        ids.append(rid)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [res[r] for r in ids]
    plens = [len(p) + (len(prefix) if behind else 0) for p, _, behind in reqs]
    ttft = sorted(first[r] - submitted[r] for r in ids)
    generated = sum(len(row) - n for row, n in zip(rows, plens))
    return {"rows": rows, "plens": plens, "wall_s": wall,
            "generated": generated, "tokens_per_s": generated / wall,
            "ttft_p50_s": statistics.median(ttft),
            "ttft_p95_s": ttft[math.ceil(0.95 * len(ttft)) - 1],
            "metrics": dict(eng.metrics)}


def picks_vs_forward(tt, params, cfg, rows, plens) -> dict:
    """Each request's greedy picks against the whole forward over its
    prompt and tokens: the largest logit gap of a pick below the forward's
    max, and the top-1 rate."""
    gap, hits, total = 0.0, 0, 0
    for row, n in zip(rows, plens):
        toks = torch.tensor([row], device=params["final_norm"].device)
        full = tt.forward(params, toks[:, :-1], cfg)[0, n - 1:]
        picks = toks[0, n:]
        gap = max(gap, (full.amax(-1) - full.gather(-1, picks[:, None])[:, 0]).max().item())
        hits += int((full.argmax(-1) == picks).sum())
        total += picks.numel()
        del full
    return {"vs_forward_max_gap": gap, "vs_forward_top1": hits / total}


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it: each is a host
    round trip through the dispatcher and, on the card, a kernel launch."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_per_decode_step(params, cfg) -> int:
    """ATen operations of one engine decode step at SERVE_ENGINE's shape
    (the same for any occupancy: idle slots compute masked no-ops)."""
    from tputopo_torch import serving

    state = serving.init_state(cfg, SERVE_ENGINE["slots"], SERVE_ENGINE["max_len"],
                               device=params["final_norm"].device)
    with _OpCount() as count:
        serving.decode_step(params, state, cfg, -1)
    return count.n


def check_rows(rows, plens, reqs, prefix, vocab, what) -> None:
    for row, n, (p, m, behind) in zip(rows, plens, reqs):
        check(len(row) == n + m, f"{what}: a request got {len(row) - n} tokens, want {m}")
        check(row[:n] == (prefix if behind else []) + p, f"{what}: prompt not echoed")
        check(all(0 <= t < vocab for t in row[n:]), f"{what}: token ids out of range")


def phase_serve(tt, kernels, params, cfg) -> tuple:
    """The engine at full width, 32 layers, bf16 over the f32 masters: the
    stream twice, identical tokens, every pick within GEN_GAP of the
    forward, no flash launch (serving attends through einsums, as the
    reference's does).  Returns (stream, flash launches of the two runs)."""
    t_phase = time.perf_counter()
    prefix, reqs = serve_stream(cfg.vocab_size, 5, SERVE_REQUESTS, SERVE_PROMPT,
                                SERVE_NEW, every=3)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state = card_state()
    runs = [run_engine(tt, params, cfg, prefix, reqs) for _ in range(2)]
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 1e9
    a, b = runs
    check(a["rows"] == b["rows"], "serve: the two runs gave different tokens")
    check_rows(b["rows"], b["plens"], reqs, prefix, cfg.vocab_size, "serve")
    check(all(n == 0 for n in launches.values()),
          f"serve launched a flash kernel: {launches}")
    vs = picks_vs_forward(tt, params, cfg, b["rows"], b["plens"])
    rec = {"phase": "serve", "model": "llama3_8b", "layers": cfg.n_layers,
           "weights": "f32 masters, bf16 compute", "kv": "bf16",
           "engine": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in SERVE_ENGINE.items()},
           "requests": len(reqs), "behind_prefix": sum(r[2] for r in reqs),
           "prompt_tokens": sum(b["plens"]), "generated": b["generated"],
           "wall_s": [a["wall_s"], b["wall_s"]],
           "tokens_per_s": [a["tokens_per_s"], b["tokens_per_s"]],
           "ttft_p50_s": [a["ttft_p50_s"], b["ttft_p50_s"]],
           "ttft_p95_s": [a["ttft_p95_s"], b["ttft_p95_s"]],
           "metrics": b["metrics"], "identical_runs": True, "launches": launches,
           "peak_mem_gb": peak, **vs, "bound_max_gap": GEN_GAP,
           "ops_per_decode_step": ops_per_decode_step(params, cfg),
           "card_state_before": state, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"serve: a pick is not the forward's greedy pick: {rec['vs_forward_max_gap']}")
    return (prefix, reqs), launches


def phase_serve_int8(tt, params, cfg, stream) -> None:
    """int8 weights (quantized on the card) and an int8 KV cache, the same
    stream through the same engine settings."""
    t_phase = time.perf_counter()
    prefix, reqs = stream
    qp = tt.quantize_params(params, bits=8)
    raw_b, int8_b = tt.streamed_bytes(params), tt.streamed_bytes(qp)
    # The weight cast each matmul pays, on one layer's w_gate [4096, 14336].
    cast_ms = {name: cuda_ms(lambda w=w: w[0].to(torch.bfloat16)) for name, w in (
        ("f32_to_bf16", params["layers"]["w_gate"]),
        ("int8_to_bf16", qp["layers"]["w_gate"]["int8"]))}
    qcfg = dataclasses.replace(cfg, kv_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    run = run_engine(tt, qp, qcfg, prefix, reqs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_rows(run["rows"], run["plens"], reqs, prefix, cfg.vocab_size, "serve_int8")
    vs = picks_vs_forward(tt, qp, cfg, run["rows"], run["plens"])
    ops = ops_per_decode_step(qp, qcfg)
    del qp
    rec = {"phase": "serve_int8", "model": "llama3_8b", "layers": cfg.n_layers,
           "weights": "int8 per output channel", "kv": "int8",
           "requests": len(reqs), "generated": run["generated"],
           "wall_s": run["wall_s"], "tokens_per_s": run["tokens_per_s"],
           "ttft_p50_s": run["ttft_p50_s"], "ttft_p95_s": run["ttft_p95_s"],
           "metrics": run["metrics"], "streamed_bytes_raw": raw_b,
           "streamed_bytes_int8": int8_b, "byte_ratio": int8_b / raw_b,
           "w_gate_layer_cast_ms": cast_ms,
           "ops_per_decode_step": ops,
           "bound_byte_ratio": SERVE_INT8_BYTE_RATIO, "peak_mem_gb": peak, **vs,
           "bound_max_gap": SERVE_INT8_GAP, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(int8_b / raw_b < SERVE_INT8_BYTE_RATIO, f"serve_int8: byte ratio {rec}")
    check(vs["vs_forward_max_gap"] <= SERVE_INT8_GAP,
          f"serve_int8: a pick is off the int8 forward's: {rec['vs_forward_max_gap']}")


def phase_serve_int4(tt, params, cfg) -> None:
    """Grouped int4 at full width, SERVE_INT4_LAYERS layers: a few requests
    against the int4 tree's own forward."""
    t_phase = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, n_layers=SERVE_INT4_LAYERS)
    cut = dict(params, layers={k: v[:SERVE_INT4_LAYERS] for k, v in params["layers"].items()})
    qp = tt.quantize_params(cut, bits=4, group_size=SERVE_INT4_GROUP)
    raw_b, int4_b = tt.streamed_bytes(cut), tt.streamed_bytes(qp)
    prefix, reqs = serve_stream(cfg.vocab_size, 6, SERVE_INT4_REQUESTS,
                                SERVE_INT4_PROMPT, SERVE_INT4_NEW, every=2)
    run = run_engine(tt, qp, cfg4, prefix, reqs)
    check_rows(run["rows"], run["plens"], reqs, prefix, cfg.vocab_size, "serve_int4")
    vs = picks_vs_forward(tt, qp, cfg4, run["rows"], run["plens"])
    del qp
    rec = {"phase": "serve_int4", "model": "llama3_8b", "layers": SERVE_INT4_LAYERS,
           "reduced": {"n_layers": [cfg.n_layers, SERVE_INT4_LAYERS]},
           "weights": f"int4, group {SERVE_INT4_GROUP}", "kv": "bf16",
           "requests": len(reqs), "generated": run["generated"],
           "wall_s": run["wall_s"], "tokens_per_s": run["tokens_per_s"],
           "metrics": run["metrics"], "streamed_bytes_raw": raw_b,
           "streamed_bytes_int4": int4_b, "byte_ratio": int4_b / raw_b, **vs,
           "bound_max_gap": GEN_GAP, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"serve_int4: a pick is off the int4 forward's: {rec['vs_forward_max_gap']}")


def profile_serve(tt, params, cfg, prefix, reqs) -> None:
    """Device profile of the bf16 engine serving the stream: the window of
    SERVE_PROFILED_TICKS ticks after SERVE_WARM_TICKS."""
    eng = tt.ServingEngine(params, cfg, **SERVE_ENGINE)
    pid = eng.register_prefix(prefix)
    for p, m, behind in reqs:
        eng.submit(p, max_new=m, prefix=pid if behind else None)
    for _ in range(SERVE_WARM_TICKS):
        eng.step()
    before = dict(eng.metrics)
    state = card_state()
    rec = device_profile("serve", lambda: [eng.step() for _ in range(SERVE_PROFILED_TICKS)])
    emit({**rec, "ticks": [SERVE_WARM_TICKS, SERVE_WARM_TICKS + SERVE_PROFILED_TICKS],
          "decode_steps": eng.metrics["decode_steps"] - before["decode_steps"],
          "prefill_chunks": eng.metrics["prefill_chunks"] - before["prefill_chunks"],
          "card_state_before": state})


def phase_train(tt, kernels) -> tuple:
    """Llama-3-8B width, 4 layers, tokens [1, 2048]: one step's loss and
    grads through the kernels against the einsum path, then TRAIN_STEPS
    AdamW steps on one batch.  Returns (state, config, tokens, launches
    of the last step)."""
    from tputopo_torch import train as tr

    cfg = dataclasses.replace(tt.ModelConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    check(cfg.remat == "block", f"remat {cfg.remat!r}")
    t0 = time.perf_counter()
    state = tt.make_train_state(cfg, 0, lr=TRAIN_LR)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tr._leaves(state.params))
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))

    loss_k, grads_k = tr.loss_and_grads(state.params, tokens, cfg)
    loss_e, grads_e = tr.loss_and_grads(
        state.params, tokens, dataclasses.replace(cfg, attn_impl="einsum"))
    def leaf_names(tree, prefix=""):  # in tr._leaves' order
        return [n for k in sorted(tree) for n in (
            leaf_names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict)
            else [prefix + k])]

    names = leaf_names(state.params)
    grad_err = {n: ((a - b).norm() / b.norm()).item()
                for n, a, b in zip(names, grads_k, grads_e)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    dloss = abs(loss_k - loss_e).item()
    del grads_k, grads_e
    rec = {"phase": "train_vs_einsum", "model": "llama3_8b", "layers": TRAIN_LAYERS,
           "tokens": [1, TRAIN_SEQ], "params": n_params, "init_s": init_s,
           "loss_kernels": loss_k.item(), "loss_einsum": loss_e.item(),
           "abs_dloss": dloss, "bound_abs_dloss": TRAIN_LOSS_TOL,
           "grad_norm_rel_err": grad_err, "bound_grad_norm_rel": TRAIN_GRAD_NORM_REL,
           "grads_finite": finite}
    emit(rec)
    check(finite and dloss <= TRAIN_LOSS_TOL
          and max(grad_err.values()) <= TRAIN_GRAD_NORM_REL,
          f"kernel-path loss/grads disagree with the einsum path: {rec}")

    want = {"flash_fwd": 2 * TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS}
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    state_before = card_state()
    for _ in range(TRAIN_STEPS):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = tt.train_step(state, tokens, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = {k.name: k.launches for k in kernels}
        check(launches == want, f"train step launched {launches}, want {want}")
        losses.append(loss.item())
    rec = {"phase": "train", "model": "llama3_8b", "layers": TRAIN_LAYERS,
           "tokens": [1, TRAIN_SEQ], "remat": cfg.remat, "lr": TRAIN_LR,
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "tokens_per_s": TRAIN_SEQ / step_s[-1], "launches_per_step": launches,
           "step": int(state.step),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card_state_before": state_before}
    emit(rec)
    check(all(map(math.isfinite, losses)), f"train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return state, cfg, tokens, launches


def phase_remat(kernels, state, cfg, tokens) -> None:
    """One loss-and-grads per remat policy at the training shape: the same
    loss (the forward is the same computation under every policy), the
    forward kernel 2·L times under "block" and L times under "dots" (its
    (o, lse) kept by the selective checkpoint) and "none"; time and peak
    memory of each."""
    from tputopo_torch import train as tr

    L = cfg.n_layers
    want = {"block": 2 * L, "dots": L, "none": L}
    rec = {"phase": "remat", "layers": L, "tokens": list(tokens.shape)}
    for policy, n_fwd in want.items():
        pcfg = dataclasses.replace(cfg, remat=policy)
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(state.params, tokens, pcfg)
        torch.cuda.synchronize()
        rec[policy] = {"loss": loss.item(), "ms": (time.perf_counter() - t0) * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": {k.name: k.launches for k in kernels}}
        del grads
        check(rec[policy]["launches"] == {"flash_fwd": n_fwd, "flash_bwd_dq": L,
                                          "flash_bwd_dkv": L},
              f"remat={policy} launched {rec[policy]['launches']}")
    emit(rec)
    for policy in ("dots", "none"):
        check(abs(rec[policy]["loss"] - rec["block"]["loss"]) <= 1e-5,
              f"remat={policy} changed the loss: {rec}")


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

    _kernels.build_all()
    for k in _kernels.KERNELS:
        k.lib()
        emit({"phase": "build", "kernel": k.name, "seconds": k.build_seconds,
              "library": k.library_path().name, "ptxas": ptxas_summary(k.build_log)})
        print(k.build_log, file=sys.stderr, flush=True)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    entries = [timed("flash", phase_flash, att, _kernels.FLASH_FWD),
               *timed("flash_bwd", phase_flash_bwd, att)]
    params, cfg, tokens, fwd_launches = timed("forward", phase_forward, tt,
                                              _kernels.KERNELS)
    prompt = timed("generate", phase_generate, tt, _kernels.KERNELS, params, cfg)
    timed("profile_forward", lambda: emit(device_profile(
        "forward", lambda: tt.forward(params, tokens, cfg))))
    timed("profile_generate", lambda: emit(device_profile(
        "generate", lambda: tt.generate(params, prompt, cfg, max_new=GEN_NEW))))
    stream, serve_launches = timed("serve", phase_serve, tt, _kernels.KERNELS,
                                   params, cfg)
    prefix, reqs = stream
    timed("profile_serve", profile_serve, tt, params, cfg, prefix, reqs)
    timed("serve_int8", phase_serve_int8, tt, params, cfg, stream)
    timed("serve_int4", phase_serve_int4, tt, params, cfg)
    # The 32-layer parameters (32.1 GB) and the training state (~31 GB)
    # are never resident together.
    del params
    gc.collect()
    torch.cuda.empty_cache()

    state, tcfg, ttokens, step_launches = timed("train", phase_train, tt,
                                                _kernels.KERNELS)
    timed("profile_train_step", lambda: emit(device_profile(
        "train_step", lambda: tt.train_step(state, ttokens, tcfg, lr=TRAIN_LR))))
    timed("remat", phase_remat, _kernels.KERNELS, state, tcfg, ttokens)
    for e in entries:
        e["launches"] = step_launches[e["name"]]  # per train step, the main path
        e["launches_by_path"] = {"forward": fwd_launches[e["name"]],
                                 "train_step": step_launches[e["name"]],
                                 "serve": serve_launches[e["name"]]}
    emit({"phase": "seconds", **seconds})
    emit({"kernels": entries})
    print(name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
