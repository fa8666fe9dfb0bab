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
   forward, then the dQ and dK/dV backward kernels, then the serving
   step's decode attention over a bf16 cache (``decode_attn``) at the
   serving cells' caches, timed beside its byte bound, and the prefill
   chunks' attention over the same caches (``chunk_attn``), timed beside
   its bound from operations and bytes;
4. the inference forward of Llama-3-8B at full width (32 layers, random
   weights from a seed) on 2048 tokens: ``attn_impl="auto"`` must launch
   the flash kernel once per layer, the logits must be finite and agree
   with the einsum path within a stated bound;
5. greedy KV-cache decoding at full width, twice, with identical tokens,
   each single-token step through ``decode_attn``, a launch a layer, and
   the prompt's prefill through ``chunk_attn``, a launch a layer;
6. serving at full width, 32 layers: the continuous-batching engine (8
   slots, chunked prefill, one shared prefix, streaming) over a seeded
   stream of 24 requests, twice with identical tokens, every greedy pick
   held against the whole forward and no flash launch, the traced run's
   ``decode_attention.launches`` one a layer for each replayed decode
   step and ``chunk_attention.launches`` one a layer for each replayed
   admission or prefix; then the same
   stream with int8 weights and an int8 KV cache, and a few requests with
   grouped int4 weights at 4 layers (below), each against its own tree's
   forward;
7. training at Llama-3-8B width, depth cut to 4 layers (below): loss and
   grads through the kernels against the einsum path, then three AdamW
   steps on one batch, each launching the forward kernel 2·L times and
   each backward kernel L times, with the loss falling; then one
   loss-and-grads under each remat policy;
8. the multi-GPU slice on the one card: a world-1 NCCL group from the
   gang env (``dist_world1``: the all-reduce measurement, which on one
   card measures no link, the link model's prediction for one GPU, and
   a calibration from a measured HBM stream); the sharded train step on
   ``{dp: 1, tp: 1}`` over that group at the training shape, equal to
   ``train_step`` bit for bit (``sharded_train_world1``); two rank
   processes on the card over gloo, ``{dp: 1, tp: 2}`` at 4 layers and
   ``{dp: 2, tp: 1}`` at 1 layer, each held against the single-process
   step (``tp2_gloo_cuda``); and, at the same time, the CLI's
   ``allreduce`` and ``train`` subcommands as subprocesses, the second
   resumed from its checkpoint (``cli``).

Between the kernel phases and the forward, ``repairs``: a forward with
head dim 256 under ``attn_impl="auto"`` (the einsum path, as the kernels
take H <= 128) and the kernels on view operands.

The serving-and-finetuning slice on one GPU: after ``serve_int4``, on the
same 32-layer weights, ``spec_generate`` (speculative decoding of one
sequence, bf16, then an f32 case at 2 layers that must equal greedy
``generate`` token for token), ``spec_serve`` (the speculative engine and
the plain one on the same requests) and ``lora_serve`` (a zero adapter
invisible, a nonzero one against the merged weights' forward, QLoRA over
int8 against the dequantized twin); after training, ``lora_train`` (the
adapter's step at the training shape, 8/4/4 launches a step, the frozen
base unchanged), and in the multi-GPU block its world-1 sharded twin
(``sharded_lora_world1``, bit for bit); then ``vision`` (the conv
classifier on the card in bf16) and the CLI's ``decode``, ``serve`` and
``train-vision`` run in this process, ``train --lora-rank`` beside the
CLI's subprocesses.

The parallelism slice: after ``lora_serve``, the MoE model at Mixtral-8x7B
width (below): ``moe_forward`` (4 layers, the kernel once a layer, the
logits against the einsum path with the same routing, layer 0's capacity
path against the drop-free one on the tokens it kept), ``moe_decode_serve``
(greedy decode, the engine and int8 weights, every pick against the
drop-free forward, no flash launch) and ``moe_train`` (2 layers, kernel
against einsum grads, three AdamW steps at 2·L/L/L launches); the kernel
cases gain the ring's chunk (S 4096, causal and not) and Ulysses' rank
shape (S 8192, 16 heads); and ``tp2_gloo_cuda`` gains the cases
``sp2_ring``, ``sp2_a2a``, ``pp2`` and ``ep2``, each rank's step held
against the single-process one with its launches; the CLI runs ``train
--experts 8`` with a resume, and refuses ``--pp 2`` on one device and
``--ep 2`` without experts with the reference's errors.

After ``lora_serve``, once the 32-layer weights are gone,
``resident_weights``: an engine at Mistral-7B-v0.3's widths serving from the
bf16 copy of its weights made when it is built, against the same engine with
the copy forced off (every program call casting the f32 masters): equal
tokens, and one f32 -> bf16 copy kernel fewer for each projection of each
layer and for the head in a device profile of a decode replay.

The compiled-program slice: every engine above (``serve*``, ``spec_serve``'s
admissions, ``lora_serve``, ``moe_decode_serve``) and the CLI's ``serve``
and ``decode`` run the compiled programs, CUDA graphs replayed from their
captures (``tputopo_torch/_graphs.py``).  After ``serve_int4``,
``compiled``: ``forward_jit`` at [1, 2048] (32 ``flash_fwd`` launches a
replay, counted from the capture and seen in a device profile of one
replay; logits bitwise equal to the eager forward's), ``generate_jit`` (tokens equal
to ``generate``'s), and the bf16, int8 + int8 KV and int4 engines against
engines driven eagerly through the same bodies (tokens equal), with the
host ops of a tick, the idle share of a profiled window, tokens/s, TTFT,
seconds capturing, graph pool bytes and peak memory of both; after
``moe_decode_serve``, ``compiled_moe``, the same equality for the MoE
engine.

The last compiled programs: the speculative ones and the training steps,
which the reference jits with their state donated.  ``train``,
``lora_train`` and ``vision`` then replay through them (the eager
``train_step`` and ``lora_train_step`` record the fingerprint of every
step); after ``spec_serve``, ``compiled_spec``: ``spec_generate`` replayed
(a prefill and a device-scalar verify step, in rounds with one readback
each) against its eager body at bf16 on 32 layers and at f32 on 2, and the
speculative engine replayed against its eager-driven twin, tokens equal
and 0 host ops in a replayed tick besides its one readback; in the
multi-GPU block, over the world-1 NCCL group, ``compiled_train`` (the
sharded step's program at the training shape, 3 calls, each bit for bit
an eager ``train_step``, 8/4/4 launches a replay; then the MoE model at 1
layer) and ``compiled_lora`` (the adapter's step, raw base and the QLoRA
int4 one); after ``vision``, ``compiled_vision`` (20 replayed steps against
20 eager ones, the losses bit for bit).  The gloo ranks of
``tp2_gloo_cuda`` run their steps eagerly: 0 captures, 0 replays.

Then the seconds of each phase, one ``kernels`` line, the card's
``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Without a GPU, or without the repository beside it,
the script fails.  ``chip_smoke.py --tp2-rank <rank> <dir>`` is the rank
process of ``tp2_gloo_cuda``, started by the script itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# Resident weights: an engine at Mistral-7B-v0.3's widths and depth (vocab
# 32768, d_model 4096, 32 q / 8 kv heads of 128, d_ff 14336, 32 layers,
# rope_theta 1e6; random weights from a seed) at the chat cell's slots,
# cache and buckets, serving a short seeded stream twice: from the bf16
# copy the engine makes when it is built, and with that copy forced off
# (the device read as full), so that every program call casts the f32
# masters.  Both run the same bodies on the same bf16 values and strides,
# so the tokens must be EQUAL.  A decode replay of the first must hold no
# weight cast: one f32 -> bf16 copy kernel fewer than the second's for each
# projection of each layer and for the head; the casts left are the
# activations', the same in both.
RESIDENT_ENGINE = dict(slots=32, max_len=2048, prompt_pad=(128, 512, 1024),
                       prefill_chunk=128, eos_id=-1)
RESIDENT_REQUESTS, RESIDENT_PROMPT, RESIDENT_NEW = 8, (16, 600), (8, 24)
RESIDENT_CAST_KERNEL = "bfloat16_copy_kernel"
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

# The decode-attention kernel against the einsums of attention.cached_attention_plain
# on the same bf16 cache: both sum the same f32 products in another order
# (the kernel in splits of 256 positions merged at the end), so the f32
# outputs differ by a few f32 ulps and their bf16 roundings by at most one
# bf16 ulp of the reference's output.  The ulp is taken at no less than
# 2**-8, the scale at which an f32 sum's own error (~1e-7 of the values
# summed) could reach a bf16 ulp of an output rounding near zero.
DECODE_ULPS, DECODE_ULP_FLOOR = 1, 2.0 ** -8
# Mistral-7B's attention (32 query heads, 8 KV heads, head dim 128) at the
# serving cells' caches: chat 32 slots x 2048, longdoc 20 slots x 8192.
DECODE_HEADS = (32, 8, 128)
DECODE_SHAPES = {"chat": (32, 2048), "longdoc": (20, 8192)}
DECODE_TS = (1, 4, 16)
# Beside them, shapes off the main path: group 2 on a cache that ends
# inside a tile, group 3, one slot; (label, B, S, N, KV, H, T).
DECODE_ODD = (("group2", 12, 200, 8, 4, 128, 3), ("group3", 12, 300, 12, 4, 128, 5),
              ("one_slot", 1, 1000, 32, 8, 128, 1))

# The chunk-attention kernel against the same einsums: it rounds P to bf16
# before P V, where the plain version keeps P in f32, as the flash forward
# rounds it against a plain version that does not, so it takes the flash
# forward's bf16 tolerance (TOL) element by element.  That tolerance is as
# large as the outputs themselves over long prefixes (an average of ~P/e
# unit-normal rows of V, |out| ~ sqrt(e/P): ~0.02 at P 5000), so each
# query head's H outputs are also held to ||kernel - plain|| / ||plain||
# <= CHUNK_ROW_REL.  On an H100 80GB HBM3 every case here and in
# tests/test_torch_chunk_attention.py reads at most 4.2e-3; the plain
# version with a 128-position tile dropped or stale reads >= 0.51, with
# the diagonal off by one >= 0.19, with P rounded to e4m3 >= 0.031, where
# the elementwise tolerance passed the last at every start from 1024 and
# the diagonal off by one at 3072 and 6144.  Shapes: the serving cells'
# prefill chunks at Mistral-7B's heads over one slot's cache (the engine
# gathers the slot), longdoc T 512 over 8192 rows, chat T 128 over 2048, at
# chunk starts across each cell's prompts; (T, S, starts).
CHUNK_SHAPES = {"longdoc": (512, 8192, (0, 1024, 2048, 3072, 4096, 5120, 6144)),
                "chat": (128, 2048, (0, 128, 384, 640, 896))}
# Beside them, shapes off the main path: (label, B, T, S, N, KV, positions):
# queries below 0 (uniform rows) for some and for all of a row's queries,
# a window past S, tile edges, group 3, a whole-bucket admission.
CHUNK_ODD = (("edges", 3, 128, 1000, 32, 8, (127, 1000 - 128 + 7, -5)),
             ("uniform", 2, 512, 2048, 32, 8, (-600, 2048 - 512)),
             ("group3", 3, 200, 700, 12, 4, (0, 129, -3)),
             ("bucket", 1, 6144, 8192, 32, 8, (0,)),
             ("short", 2, 17, 300, 32, 8, (128, 300 - 17)))
CHUNK_ROW_REL = 1e-2
# The admission programs, each a chunk-attention launch a layer a replay.
CHUNK_PROGRAMS = ("admit", "prefill_chunk", "admit_final_chunk", "build_prefix_cache")

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
# under the causal mask), the per-rank shape of the tp = 2 run (the
# model's 32 heads split in two), the ring's chunk of S 4096 (its full
# chunks non-causal, its diagonal causal: sp2_ring), Ulysses' whole
# sequence of 8192 with half the heads (sp2_a2a), and the model's shape
# (last).
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
    (1, 2048, 16, 128, torch.bfloat16, True, 128, 128),
    (1, 4096, 32, 128, torch.bfloat16, False, 256, 256),
    (1, 4096, 32, 128, torch.bfloat16, True, 256, 256),
    (1, 8192, 16, 128, torch.bfloat16, True, 512, 512),
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

# The multi-GPU slice.  The world-1 all-reduce payload is the reference
# CLI's default (16 MB); the HBM stream copies 2 GiB (read once, written
# once), far above the 50 MB L2.
ALLREDUCE_MB, STREAM_BYTES = 16.0, 2 << 30
# Two rank processes on the one card over gloo (NCCL refuses two ranks on
# one device), each held against the single-process step on the same seed
# and tokens with train_vs_einsum's bounds: the ranks' bf16 partial sums
# add in another order (tp, ep, the sp sum of grads), the rows' grads in
# another order (dp), the ring merges its chunks by their LSEs (sp2_ring).
# pp2 runs [2, 2048], not [4, 2048]: each pp rank computes the f32 head
# and its gradient on the whole batch, ~4 x 4.2 GB at 4 rows, which beside
# the two ranks' 20 GB states would pass 75 GB.
# (name, axes, model, layers, tokens [rows, seq], options)
TP2_CASES = (("tp2", {"dp": 1, "tp": 2}, "llama3_8b", TRAIN_LAYERS, (1, TRAIN_SEQ), {}),
             ("dp2", {"dp": 2, "tp": 1}, "llama3_8b", 1, (2, TRAIN_SEQ), {}),
             ("sp2_ring", {"sp": 2}, "llama3_8b", 1, (1, 8192), {}),
             ("sp2_a2a", {"sp": 2}, "llama3_8b", 1, (1, 8192), {"sp_impl": "a2a"}),
             ("pp2", {"pp": 2}, "llama3_8b", 2, (2, TRAIN_SEQ), {"n_micro": 2}),
             ("ep2", {"ep": 2}, "mixtral_8x7b", 1, (1, TRAIN_SEQ), {}))
# Head dim 256: Llama-3-8B's width with 16 query heads (8 kv), one layer.
REPAIR_HEADS = 16

# Speculative decoding over the 32-layer weights: the draft is their first
# 4 layers, 4 draft tokens a tick; one sequence (prompt 128, 64 new), then
# the engine on 8 of serve_stream's prompts, 32 new each, no prefix (the
# speculative engine takes none).  Picks are held to GEN_GAP, as every
# bf16 path.  At f32 speculation is lossless: 2 layers at full width over
# the f32 masters (sliced, no copy), draft 1 layer, must give greedy
# generate's tokens, each pick within SPEC_F32_GAP of the f32 forward's
# max, f32 rounding over two layers.  Random weights set the acceptance
# rate: no figure here is a speed result of speculation.
SPEC_DRAFT_LAYERS, SPEC_GAMMA, SPEC_PROMPT, SPEC_NEW = 4, 4, 128, 64
SPEC_F32_LAYERS, SPEC_F32_GAP = 2, 1e-3
SPEC_SERVE_REQUESTS, SPEC_SERVE_NEW = 8, 32
SPEC_ENGINE = dict(slots=8, max_len=2048, prompt_pad=(128, 512, 1024),
                   draft_layers=SPEC_DRAFT_LAYERS, gamma=SPEC_GAMMA)
# LoRA: rank 8 on wq and wv (the reference's default targets), b drawn
# N(0, 0.02) where the delta must show (tests/test_lora.py:104-105); 4
# requests of 16 new tokens through SERVE_ENGINE.  QLoRA: an int8 base with
# an int8 KV cache, against the forward of the dequantized twin (bf16, the
# compute dtype) with the same adapter: SERVE_INT8_GAP.
LORA_RANK, LORA_B_STD = 8, 0.02
LORA_REQUESTS, LORA_PROMPT, LORA_NEW = 4, (16, 512), (16, 16)
# The adapter's train step at the training shape (TRAIN_LAYERS, [1, 2048],
# remat "block", lr TRAIN_LR): the base frozen in f32, the adapter alone
# trained.
LORA_TRAIN_STEPS = 3
# MoE: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
# config.json: d_model 4096, 32 q / 8 kv heads, head dim 128, d_ff 14336,
# 8 experts, top 2, vocab 32000, rope_theta 1e6, norm eps 1e-5), random
# weights from a seed, the reference's MoEConfig defaults (capacity factor
# 1.25, aux weight 1e-2).  Depth is cut for memory only: the forward and
# serving at 4 layers (f32 masters ~24 GB), training at 2 (3.17 B
# parameters at 16 B each, ~51 GB of state).  At capacity factor
# E / top_k = 4 the capacity is the whole group and nothing drops: the
# drop-free semantics that decode serves.
MOE_FWD_LAYERS, MOE_TRAIN_LAYERS, MOE_SEQ = 4, 2, 2048
MOE_SERVE_REQUESTS, MOE_INT8_REQUESTS = 8, 4
# The capacity path against the drop-free one on the tokens it kept, one
# layer, the same bf16 input: the same expert products in other shapes,
# so two bf16 ulps as the flash bounds.
MOE_KEPT_TOL = TOL[torch.bfloat16]
# Layer 0 of the random-weight model drops no seat at capacity factor 1.25
# (its heaviest expert stays under capacity 640 at [1, 2048], measured on
# one H100), so the kept-token check also runs at 1.0 (capacity 512), where
# seats do drop.
MOE_TIGHT_CF = 1.0
# The routed expert layer of serving (moe.moe_mlp_routed: sort, grouped bf16
# GEMMs, combine) on layer 0 of the MoE weights: a decode step of one slot
# and of chat's 32 slots, a prefill chunk and a 512-token bucket, the last
# expert given no pair.  Its bf16 activations against the loop's f32 ones
# (moe.moe_mlp_reference, the same bf16-rounded tables): four bf16
# roundings in a row, held at 2% of the largest output, the CPU tests' bound.
MOE_GROUPED_TOKENS = (1, 32, 128, 512)
MOE_GROUPED_REL = 2e-2
# The conv classifier on the card in bf16: the reference CLI's run.
VISION_STEPS, VISION_BATCH = 20, 64
# The compiled programs (CUDA graphs, tputopo_torch/_graphs.py): each engine
# that replays them against one driven eagerly through the same bodies (an
# engine whose _program calls the eager functions), on the same requests.
# A replay launches the eager body's kernels in its order on the same
# buffers, so the tokens must be EQUAL.  The int8 engines take the first
# COMPILED_INT8_REQUESTS requests of the serve stream, for time (the eager
# int8 engine took 30 s over all 24 after PR 8); the ops of a tick are
# counted on an engine serving COMPILED_OPS_REQUESTS short requests after
# COMPILED_OPS_WARM steps.
COMPILED_INT8_REQUESTS = 8
COMPILED_OPS_REQUESTS, COMPILED_OPS_WARM = 2, 2
# The jitted training steps (donated programs): COMPILED_CALLS calls of each,
# the first its warm-up (which does the step) and capture, the rest
# replays, each held bit for bit against the eager step from the same seed.
# The MoE step at Mixtral width goes through the same program at 1 layer
# (moe_train runs 2 eagerly, 62.0 GB at its peak; the program's pool keeps
# the grads and saved activations resident beside the state, so the depth
# is cut to 1 for memory).  The QLoRA int4 base trains on [1, 256]: the
# grouped int4 head's f32 partials are [tokens, 32, 128256], 33.6 GB at
# 2048 tokens before its backward.
COMPILED_CALLS, COMPILED_MOE_LAYERS, QLORA_INT4_SEQ = 3, 1, 256
# The keys the reference CLI prints (tputopo/workloads/__main__.py).
CLI_KEYS = {
    "decode": {"batch", "prompt_len", "max_new", "mesh", "decode_tokens_per_s", "wall_s"},
    "serve": {"requests", "slots", "mesh", "prompt_lens", "prefix_len",
              "generated_tokens", "decode_steps", "prefix_admits", "tokens_per_s",
              "wall_s"},
    "train-vision": {"devices", "mesh", "steps", "first_loss", "last_loss"},
    "train": {"devices", "mesh", "steps", "resumed_from", "final_step", "preempted",
              "first_loss", "last_loss"},
}


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call as a CUDA graph replays it: ``calls`` calls
    captured in one graph, timed by :func:`cuda_ms` over replays, divided
    by ``calls``.  No host work is left between the calls, as in a replayed
    serving step, where a wrapper's own host time would otherwise be timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, launches=5) / calls
    del graph
    return ms


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


def reset(kernels) -> None:
    """Set every kernel's launch count to 0."""
    for k in kernels:
        k.launches = 0


def launch_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


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


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor, floor: float) -> torch.Tensor:
    """|got - ref| in bf16 ulps of ref's magnitude, taken at no less than
    ``floor``: a bf16 of magnitude in [2**(e-1), 2**e) has ulp 2**(e-8)."""
    _, e = torch.frexp(ref.float().abs().clamp(min=floor))
    return (got.float() - ref.float()).abs() / torch.exp2(e.float() - 8)


def decode_positions(cell: str, B: int, S: int, seed: int) -> torch.Tensor:
    """Slot positions as a serving cell holds them mid-run: a request's
    prompt plus a uniform share of its answer, drawn from the cell's
    lengths; chat has about 22 of 32 slots busy at 2.4 requests/s, its idle
    slots at S - 1 (where the decode step parks them)."""
    rng = np.random.default_rng(seed)
    if cell == "chat":
        prompt = np.clip(np.exp(rng.normal(np.log(256), 0.8, B)), 16, 1024)
        answer = np.clip(np.exp(rng.normal(np.log(64), 0.8, B)), 16, 512)
        pos = prompt + rng.uniform(size=B) * answer
        pos[22:] = S - 1
    else:
        prompt = rng.uniform(1536, 6144, B)
        answer = np.clip(np.exp(rng.normal(np.log(256), 0.6, B)), 64, 1024)
        pos = prompt + rng.uniform(size=B) * answer
    return torch.tensor(np.minimum(pos.astype(np.int64), S - 1), device="cuda")


def decode_bound_ms(pos: torch.Tensor, T: int, S: int, N: int, KV: int, H: int) -> float:
    """Least time for one decode-attention call: every cache row a slot's
    queries attend (K and V, bf16) read once, q read and out written once,
    at the card's memory rate; its f32 operations are far below their
    peak's share."""
    last = torch.where(pos < 0, S - 1, torch.clamp(pos + T - 1, max=S - 1))
    rows = int((last + 1).sum())
    nbytes = rows * KV * H * 2 * 2 + 2 * pos.numel() * T * N * H * 2
    return nbytes / PEAK_BYTES * 1e3


def phase_decode_attn(att, kernel) -> dict:
    """The decode-attention kernel against its plain version's einsums at Mistral's
    heads and both serving cells' caches, T in DECODE_TS; positions at 0, a
    tile's and a split's edges, S - 1 (an idle slot), below 0 (every
    position masked for the first query) and past S - 1; two launches bit
    for bit.  Then timed at each cell's shape and position mix, T = 1, as
    captured graphs replay it (:func:`graph_ms`), beside its byte bound, the
    einsums and masked SDPA (a yardstick the port never calls)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = []
    shapes = [(cell, B, S, *DECODE_HEADS, T) for cell, (B, S) in DECODE_SHAPES.items()
              for T in DECODE_TS] + list(DECODE_ODD)
    key = ck = cv = None
    for cell, B, S, N, KV, H, T in shapes:
        if key != (B, S, KV, H):  # one cache per shape, the last one freed first
            key = ck = cv = None
            ck, cv = (torch.randn((B, S, KV, H), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(2))
            key = (B, S, KV, H)
        q = torch.randn((B, T, N, H), generator=gen, device="cuda", dtype=torch.bfloat16)
        edges = [0, 63, 64, 255, 256, 257, S - 1, -1, -T, S - T, S + 3][:B]
        pos = torch.randint(0, S - T + 1, (B,), generator=gen, device="cuda")
        pos[:len(edges)] = torch.tensor(edges, device="cuda")
        before = kernel.launches
        got = att._decode_attention_cuda(q, ck, cv, pos)
        again = att._decode_attention_cuda(q, ck, cv, pos)
        ref = att.cached_attention_plain(q, ck, cv, pos, N // KV)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, ref, DECODE_ULP_FLOOR)
        masked = ulps[7, 0].max().item() if B > 7 else None
        rec = {"phase": "decode_attn_vs_plain", "cell": cell, "shape": [B, T, S, N, KV, H],
               "edge_positions": edges, "max_ulps": ulps.max().item(),
               "elements_differing": int((got != ref).sum()),
               "max_abs_err": (got.float() - ref.float()).abs().max().item(),
               "all_masked_row_max_ulps": masked,
               "tolerance": {"bf16_ulps": DECODE_ULPS, "ulp_floor": DECODE_ULP_FLOOR},
               "repeat_bitwise": bool(torch.equal(got, again)),
               "launches": kernel.launches - before}
        rec["within"] = rec["max_ulps"] <= DECODE_ULPS
        emit(rec)
        check(bool(torch.isfinite(got.float()).all()), "decode_attn output not finite")
        check(rec["within"], f"decode_attn disagrees with the einsums: {rec}")
        check(rec["repeat_bitwise"], f"decode_attn: two launches differ: {rec}")
        check(rec["launches"] == 2, f"decode_attn: {rec['launches']} launches, want 2")
        cases.append(rec)
    del ck, cv

    N, KV, H = DECODE_HEADS
    group = N // KV
    timing = {}
    for cell, (B, S) in DECODE_SHAPES.items():
        ck, cv = (torch.randn((B, S, KV, H), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        q = torch.randn((B, 1, N, H), generator=gen, device="cuda", dtype=torch.bfloat16)
        pos = decode_positions(cell, B, S, 17)
        kernel_ms = graph_ms(lambda: att._decode_attention_cuda(q, ck, cv, pos))
        plain_ms = graph_ms(lambda: att.cached_attention_plain(q, ck, cv, pos, group))
        # SDPA's layout [B, heads, S, H], copied outside the timed calls
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ck, cv))
        mask = (torch.arange(S, device="cuda") <= pos[:, None])[:, None, None, :]
        library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        bound_ms = decode_bound_ms(pos, 1, S, N, KV, H)
        timing[cell] = {"shape": [B, 1, S, N, KV, H], "live_rows": int((pos + 1).sum()),
                        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound_ms,
                        "bound_share": bound_ms / kernel_ms}
        emit({"phase": "decode_attn_timing", "cell": cell, **timing[cell],
              "library": "scaled_dot_product_attention, boolean mask, enable_gqa",
              "bound_by": "bytes"})
        del ck, cv, kt, vt
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": kernel.name, "route": "cuda",
            "source": kernel.source.relative_to(REPO).as_posix(),
            "replaces": "none: tputopo/workloads/serving.py:_attend_ragged's einsums",
            "max_ulps": max(c["max_ulps"] for c in cases), "timing": timing}


def chunk_work(pos: torch.Tensor, T: int, S: int, N: int, KV: int, H: int) -> tuple:
    """(flops, bytes) one chunk-attention call needs: 4 H flops (two
    products) a head for every (query, attended position) pair, a query
    below 0 attending all S; q read and out written once, every cache row
    some query attends read once (K and V, bf16)."""
    qp = pos[:, None].cpu() + torch.arange(T)
    last = torch.where(qp < 0, S - 1, qp.clamp(max=S - 1))
    pairs = int((last + 1).sum())
    rows = int((last.amax(dim=1) + 1).sum())
    return 4.0 * H * N * pairs, rows * KV * H * 2 * 2 + 2 * pos.numel() * T * N * H * 2


def chunk_bound_ms(pos, T, S, N, KV, H) -> tuple[float, str]:
    """Least time for one chunk-attention call at the card's bf16 peak and
    memory rate, and which of the two bounds it."""
    flops, nbytes = chunk_work(pos, T, S, N, KV, H)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_chunk_attn(att, kernel) -> dict:
    """The chunk-attention kernel against its plain version's einsums at
    Mistral's heads, the serving cells' chunk shapes and CHUNK_ODD's, within
    the flash forward's bf16 tolerance element by element and CHUNK_ROW_REL
    a query head; two launches bit for bit.  Then
    timed at each cell's shape and chunk starts, as captured graphs replay
    it (:func:`graph_ms`), beside its bound, the einsums and masked SDPA (a
    yardstick the port never calls)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    N, KV, H = DECODE_HEADS
    rtol, atol = TOL[torch.bfloat16]
    shapes = [(cell, 1, T, S, N, KV, (p,)) for cell, (T, S, starts) in CHUNK_SHAPES.items()
              for p in starts] + [(c, B, T, S, n, kv, p) for c, B, T, S, n, kv, p in CHUNK_ODD]
    cases = []
    for cell, B, T, S, n, kv, positions in shapes:
        ck, cv = (torch.randn((B, S, kv, H), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        q = torch.randn((B, T, n, H), generator=gen, device="cuda", dtype=torch.bfloat16)
        pos = torch.tensor(positions, device="cuda")
        before = kernel.launches
        got = att._chunk_attention_cuda(q, ck, cv, pos)
        again = att._chunk_attention_cuda(q, ck, cv, pos)
        ref = att.cached_attention_plain(q, ck, cv, pos, n // kv)
        torch.cuda.synchronize()
        diff = got.float() - ref.float()
        err = diff.abs()
        rec = {"phase": "chunk_attn_vs_plain", "cell": cell, "shape": [B, T, S, n, kv, H],
               "positions": list(positions), "max_abs_err": err.max().item(),
               "max_err_over_tol": (err / (atol + rtol * ref.float().abs())).max().item(),
               "tolerance": {"atol": atol, "rtol": rtol},
               "max_row_rel_err": (diff.norm(dim=-1) / ref.float().norm(dim=-1)).max().item(),
               "bound_row_rel": CHUNK_ROW_REL,
               "repeat_bitwise": bool(torch.equal(got, again)),
               "launches": kernel.launches - before}
        rec["within"] = (rec["max_err_over_tol"] <= 1.0
                         and rec["max_row_rel_err"] <= CHUNK_ROW_REL)
        emit(rec)
        check(bool(torch.isfinite(got.float()).all()), "chunk_attn output not finite")
        check(rec["within"], f"chunk_attn disagrees with the einsums: {rec}")
        check(rec["repeat_bitwise"], f"chunk_attn: two launches differ: {rec}")
        check(rec["launches"] == 2, f"chunk_attn: {rec['launches']} launches, want 2")
        cases.append(rec)
        del ck, cv, q, got, again, ref, diff, err

    timing = {}
    for cell, (T, S, starts) in CHUNK_SHAPES.items():
        ck, cv = (torch.randn((1, S, KV, H), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        q = torch.randn((1, T, N, H), generator=gen, device="cuda", dtype=torch.bfloat16)
        # SDPA's layout [B, heads, S, H], copied outside the timed calls
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ck, cv))
        rows = []
        for p in starts:
            pos = torch.tensor([p], device="cuda")
            mask = torch.arange(S, device="cuda") <= p + torch.arange(T, device="cuda")[:, None]
            kernel_ms = graph_ms(lambda: att._chunk_attention_cuda(q, ck, cv, pos))
            plain_ms = graph_ms(lambda: att.cached_attention_plain(q, ck, cv, pos, N // KV),
                                calls=4)
            library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), calls=4)
            bound_ms, bound_by = chunk_bound_ms(pos, T, S, N, KV, H)
            flops, nbytes = chunk_work(pos, T, S, N, KV, H)
            rows.append({"start": p, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "flops": flops, "bytes": nbytes, "bound_share": bound_ms / kernel_ms})
        total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "plain_ms", "library_ms",
                                                      "bound_ms")}
        timing[cell] = {"shape": [1, T, S, N, KV, H], "starts": rows, **total,
                        "bound_share": total["bound_ms"] / total["kernel_ms"]}
        emit({"phase": "chunk_attn_timing", "cell": cell, **timing[cell],
              "library": "scaled_dot_product_attention, boolean mask, enable_gqa"})
        del ck, cv, q, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": kernel.name, "route": "cuda",
            "source": kernel.source.relative_to(REPO).as_posix(),
            "replaces": "none: tputopo/workloads/serving.py:_attend_ragged's einsums",
            "max_err_over_tol": max(c["max_err_over_tol"] for c in cases),
            "max_row_rel_err": max(c["max_row_rel_err"] for c in cases),
            "timing": {cell: {k: v for k, v in t.items() if k != "starts"}
                       for cell, t in timing.items()}}


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

    reset(kernels)
    t0 = time.perf_counter()
    logits = tt.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = launch_counts(kernels)

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


def phase_generate(tt, kernels, params, cfg) -> tuple:
    """Greedy KV-cache decode at full width, twice; each single-token step
    attends through the decode-attention kernel, a launch a layer, and the
    128-token prefill through the chunk-attention kernel, a launch a layer.
    Returns (the prompt, the two kernels' launches of one run)."""
    B, P, new = GEN_BATCH, GEN_PROMPT, GEN_NEW
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    attn = (tt._kernels.DECODE_ATTN, tt._kernels.CHUNK_ATTN)
    runs = []
    for _ in range(2):
        reset(kernels)
        before = [k.launches for k in attn]
        t0 = time.perf_counter()
        out = tt.generate(params, prompt, cfg, max_new=new)
        torch.cuda.synchronize()
        runs.append((out, time.perf_counter() - t0,
                     [k.launches - n for k, n in zip(attn, before)]))
    (a, _, _), (b, dt, (decode_attn, chunk_attn)) = runs
    check(tuple(a.shape) == (B, P + new), f"generate shape {tuple(a.shape)}")
    check(bool(((a >= 0) & (a < cfg.vocab_size)).all()), "generated ids out of range")
    check(bool(torch.equal(a[:, :P], prompt)), "generate changed the prompt")
    check(bool(torch.equal(a, b)), "greedy generate is not deterministic")
    gen_launches = launch_counts(kernels)
    # The cached path against the whole forward over the generated tokens.
    full = tt.forward(params, a[:, :-1], cfg)[:, P - 1:]
    picks = a[:, P:]
    top1 = (full.argmax(-1) == picks).float().mean().item()
    gap = (full.amax(-1) - full.gather(-1, picks[..., None])[..., 0]).max().item()
    emit({"phase": "generate", "model": "llama3_8b", "batch": B, "prompt": P,
          "max_new": new, "wall_s": dt, "new_tokens_per_s": B * new / dt,
          "launches": gen_launches, "decode_attn_launches": decode_attn,
          "chunk_attn_launches": chunk_attn, "identical_runs": True,
          "vs_forward_top1": top1, "vs_forward_max_gap": gap,
          "bound_max_gap": GEN_GAP})
    check(gap <= GEN_GAP, f"a generated token is not the forward's greedy pick: "
                          f"logit gap {gap} > {GEN_GAP}")
    check(decode_attn == cfg.n_layers * (new - 1),
          f"generate: decode_attn launches {decode_attn}, want {cfg.n_layers} a step")
    check(chunk_attn == cfg.n_layers,
          f"generate: chunk_attn launches {chunk_attn}, want {cfg.n_layers} a prefill")
    return prompt, decode_attn, chunk_attn


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


def run_engine(tt, params, cfg, prefix, reqs, make=None) -> dict:
    """One engine serving the stream, every request submitted at once;
    the host clock from before the prefix's registration (when there is a
    prefix) to the drained queue.  Time to first token is, per request,
    from its submit to the streaming callback's first call for it.
    ``make(on_tokens)`` builds the engine; by default the plain engine
    with SERVE_ENGINE's settings."""
    first: dict[int, float] = {}

    def on_tokens(rid, toks):
        first.setdefault(rid, time.perf_counter())

    if make is None:
        def make(cb):
            return tt.ServingEngine(params, cfg, on_tokens=cb, **SERVE_ENGINE)
    eng = make(on_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pid = eng.register_prefix(prefix) if prefix is not None else None
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
    progs = eng.programs
    return {"rows": rows, "plens": plens, "wall_s": wall,
            "generated": generated, "tokens_per_s": generated / wall,
            "ttft_p50_s": statistics.median(ttft),
            "ttft_p95_s": ttft[math.ceil(0.95 * len(ttft)) - 1],
            "metrics": dict(eng.metrics),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "programs": {"captures": dict(progs.captures), "replays": dict(progs.replays),
                         "capture_s": progs.capture_seconds,
                         "pool_bytes": pool_bytes(progs.pool)}}


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
    """Counts the ATen operations dispatched inside it on the card's
    tensors: each is a host round trip through the dispatcher and a kernel
    launch, but ``reads``, the readbacks (a scalar read of a device tensor,
    or a device tensor copied to the host), which wait for the device
    instead.  An operation on host tensors alone (the int of a value
    already read back) launches nothing and is not counted."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        device = kwargs.get("device")
        if (any(t.device.type != "cpu" for t in tensors)
                or (device is not None and torch.device(device).type != "cpu")):
            self.n += 1
            to_host = ((func is torch.ops.aten._to_copy.default and device is not None
                        and torch.device(device).type == "cpu")
                       or (func is torch.ops.aten.copy_.default
                           and args[0].device.type == "cpu"))
            self.reads += to_host or func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **kwargs)


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
    reference's does).  The engine replays its compiled programs.  Returns
    (stream, flash launches of the two runs, the two runs)."""
    t_phase = time.perf_counter()
    prefix, reqs = serve_stream(cfg.vocab_size, 5, SERVE_REQUESTS, SERVE_PROMPT,
                                SERVE_NEW, every=3)
    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    state = card_state()
    tracer = tt.obs.Tracer()
    runs = [run_engine(tt, params, cfg, prefix, reqs),
            run_engine(tt, params, cfg, prefix, reqs, make=lambda cb: tt.ServingEngine(
                params, cfg, on_tokens=cb, tracer=tracer, **SERVE_ENGINE))]
    launches = launch_counts(kernels)
    traced = tracer.export()
    decode_attn = {"launches": traced["decode_attention"]["launches"],
                   "decode_steps_replayed": traced["programs"]["replays"].get("decode_step", 0)}
    chunk_attn = {"launches": traced["chunk_attention"]["launches"],
                  "admissions_replayed": sum(traced["programs"]["replays"].get(n, 0)
                                             for n in CHUNK_PROGRAMS)}
    grouped_launches = traced["grouped_mm"]["launches"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    a, b = runs
    check(a["rows"] == b["rows"], "serve: the two runs gave different tokens")
    check_rows(b["rows"], b["plens"], reqs, prefix, cfg.vocab_size, "serve")
    check(all(n == 0 for n in launches.values()),
          f"serve launched a flash kernel: {launches}")
    check(decode_attn["decode_steps_replayed"] > 0 and decode_attn["launches"]
          == cfg.n_layers * decode_attn["decode_steps_replayed"],
          f"serve: decode_attn launches {decode_attn}, want {cfg.n_layers} a replayed step")
    check(chunk_attn["admissions_replayed"] > 0 and chunk_attn["launches"]
          == cfg.n_layers * chunk_attn["admissions_replayed"],
          f"serve: chunk_attn launches {chunk_attn}, want {cfg.n_layers} a replayed admission")
    check(grouped_launches == 0 and "moe" not in traced,
          f"serve: the dense engine ran the routed expert layer: {grouped_launches} launches")
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
           "decode_attn_traced": decode_attn, "chunk_attn_traced": chunk_attn,
           "grouped_mm_launches": grouped_launches,
           "peak_mem_gb": peak, "programs": [a["programs"], b["programs"]],
           **vs, "bound_max_gap": GEN_GAP,
           "ops_per_decode_step": ops_per_decode_step(params, cfg),
           "card_state_before": state, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"serve: a pick is not the forward's greedy pick: {rec['vs_forward_max_gap']}")
    return (prefix, reqs), launches, runs, decode_attn, chunk_attn


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
    decode_attn, chunk_attn = tt._kernels.DECODE_ATTN.launches, tt._kernels.CHUNK_ATTN.launches
    run = run_engine(tt, qp, qcfg, prefix, reqs)
    decode_attn = tt._kernels.DECODE_ATTN.launches - decode_attn
    chunk_attn = tt._kernels.CHUNK_ATTN.launches - chunk_attn
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
           "ops_per_decode_step": ops, "decode_attn_launches": decode_attn,
           "chunk_attn_launches": chunk_attn,
           "bound_byte_ratio": SERVE_INT8_BYTE_RATIO, "peak_mem_gb": peak, **vs,
           "bound_max_gap": SERVE_INT8_GAP, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(int8_b / raw_b < SERVE_INT8_BYTE_RATIO, f"serve_int8: byte ratio {rec}")
    check(decode_attn == 0, f"serve_int8: the int8 cache launched decode_attn {decode_attn} "
                            "times; it keeps the einsums")
    check(chunk_attn == 0, f"serve_int8: the int8 cache launched chunk_attn {chunk_attn} "
                           "times; it keeps the einsums")
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


def profile_serve(tt, params, cfg, prefix, reqs, engine=None, path="serve") -> dict:
    """Device profile of the bf16 engine serving the stream: the window of
    SERVE_PROFILED_TICKS ticks after SERVE_WARM_TICKS (by then every
    program of the window is captured).  ``engine`` is the engine class,
    by default the plain one, which replays its programs."""
    eng = (engine or tt.ServingEngine)(params, cfg, **SERVE_ENGINE)
    pid = eng.register_prefix(prefix)
    for p, m, behind in reqs:
        eng.submit(p, max_new=m, prefix=pid if behind else None)
    for _ in range(SERVE_WARM_TICKS):
        eng.step()
    before = dict(eng.metrics)
    state = card_state()
    rec = device_profile(path, lambda: [eng.step() for _ in range(SERVE_PROFILED_TICKS)])
    rec.update({"ticks": [SERVE_WARM_TICKS, SERVE_WARM_TICKS + SERVE_PROFILED_TICKS],
                "decode_steps": eng.metrics["decode_steps"] - before["decode_steps"],
                "prefill_chunks": eng.metrics["prefill_chunks"] - before["prefill_chunks"],
                "card_state_before": state})
    emit(rec)
    return rec


def pool_bytes(pool) -> int | None:
    """Bytes of the segments the caching allocator holds for a graph
    memory pool (``segment_pool_id`` of ``torch.cuda.memory_snapshot``);
    None where the snapshot does not name pools."""
    if pool is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def mistral_config(tt, layers: int = 32):
    """Mistral-7B-v0.3 at its published widths, ``layers`` deep."""
    return tt.ModelConfig(vocab_size=32768, d_model=4096, n_layers=layers, n_heads=32,
                          n_kv_heads=8, d_ff=14336, max_seq=32768, rope_theta=1e6,
                          norm_eps=1e-5)


def cast_kernels(fn) -> dict:
    """The f32 -> bf16 copy kernels of one call of ``fn`` in a device
    profile: their number and device milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms, busy = 0, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        busy += dev_us / 1e3
        if RESIDENT_CAST_KERNEL in ev.key:
            n += ev.count
            ms += dev_us / 1e3
    return {"casts": n, "cast_ms": ms, "device_busy_ms": busy}


@contextlib.contextmanager
def copy_forced_off():
    """Within the block, a serving engine reads the device as full and
    serves from the masters, casting them on every call."""
    from tputopo_torch import serving

    read = serving._free_bytes
    serving._free_bytes = lambda device: 0
    try:
        yield
    finally:
        serving._free_bytes = read


def phase_resident_weights(tt) -> dict:
    """The engine's resident bf16 weights against per-call casts at Mistral-7B
    width (RESIDENT_ENGINE): equal tokens over a seeded stream, and in a
    device profile of one decode replay 7 · L + 1 f32 -> bf16 copy kernels
    fewer (none of them a weight's), with each replay's device time."""
    from tputopo_torch.quant import compute_bytes

    t_phase = time.perf_counter()
    cfg = mistral_config(tt)
    params = tt.init_params(cfg, 11, device="cuda")
    _, reqs = serve_stream(cfg.vocab_size, 12, RESIDENT_REQUESTS, RESIDENT_PROMPT,
                           RESIDENT_NEW, every=RESIDENT_REQUESTS + 1)
    reqs = [(p, m, False) for p, m, _ in reqs]
    runs, profiles, replay_ms, weights = [], [], [], []
    for forced_off in (False, True):
        with copy_forced_off() if forced_off else contextlib.nullcontext():
            eng = tt.ServingEngine(params, cfg, **RESIDENT_ENGINE)
        runs.append(run_engine(tt, params, cfg, None, reqs,
                               make=lambda cb, e=eng: setattr(e, "on_tokens", cb) or e))
        profiles.append(cast_kernels(eng._decode_tick))
        replay_ms.append(cuda_ms(eng._decode_tick, launches=10))
        weights.append(dict(eng.weights))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    resident, cast = profiles
    weight_casts = 7 * cfg.n_layers + 1
    rec = {"phase": "resident_weights", "model": "mistral-7b-v0.3 widths", "layers": cfg.n_layers,
           "engine": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in RESIDENT_ENGINE.items()},
           "requests": len(reqs), "generated": runs[0]["generated"],
           "weights": {"resident": weights[0], "forced_off": weights[1]},
           "compute_bytes": compute_bytes(params, cfg.compute_dtype),
           "decode_replay": {"resident": resident, "forced_off": cast},
           "decode_replay_ms": {"resident": replay_ms[0], "forced_off": replay_ms[1]},
           "weight_casts_per_replay": weight_casts,
           "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
           "programs": [r["programs"] for r in runs],
           "identical_runs": runs[0]["rows"] == runs[1]["rows"],
           "card_state": card_state(), "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(weights[0]["resident"] == 1 and weights[0]["bytes"] == rec["compute_bytes"]
          and weights[1] == {"resident": 0, "bytes": 0, "leaves": 0},
          f"resident_weights: the engines' weights records {weights}")
    check(rec["identical_runs"], "resident_weights: the resident copy changed the tokens")
    check_rows(runs[0]["rows"], runs[0]["plens"], reqs, None, cfg.vocab_size,
               "resident_weights")
    check(cast["casts"] - resident["casts"] == weight_casts,
          f"resident_weights: {resident['casts']} f32 -> bf16 copies in a resident decode "
          f"replay, {cast['casts']} casting; want {weight_casts} fewer")
    return rec


def eager_engine(base):
    """``base`` driven eagerly: every device program is its eager body
    (``serving.admit`` for ``admit_jit``, ``speculative.spec_tick_eager``
    for ``spec_tick`` ...), with no capture."""
    from tputopo_torch import serving, speculative

    class Eager(base):
        def _program(self, name, *args, **kw):
            fn = speculative.EAGER_PROGRAMS.get(name) or getattr(serving, name)
            return fn(*args, **kw)

    return Eager


def ops_per_tick(engine, params, cfg, settings=None) -> dict:
    """Host ATen operations of one decode tick and of one whole engine step
    (harvest, admission, the tick, its readbacks), on an engine of
    ``engine``'s class (``settings``, by default SERVE_ENGINE's) serving two
    short requests after its programs were captured (COMPILED_OPS_WARM
    steps); the scalar readbacks among them beside."""
    eng = engine(params, cfg, **(settings or SERVE_ENGINE))
    for i in range(COMPILED_OPS_REQUESTS):
        eng.submit(list(range(1, 17 + i)), max_new=16)
    for _ in range(COMPILED_OPS_WARM):
        eng.step()
    with _OpCount() as tick:
        eng._decode_tick()
    with _OpCount() as step:
        eng.step()
    return {"decode_tick": tick.n, "engine_step": step.n,
            "decode_tick_readbacks": tick.reads, "engine_step_readbacks": step.reads}


def phase_compiled(tt, kernels, params, cfg, tokens, prompt, stream, serve_runs,
                   serve_profile) -> dict:
    """The compiled programs at full width, 32 layers: ``forward_jit`` on
    [1, 2048] (32 flash_fwd launches a replay, in the capture's count and
    in a device profile; logits bitwise equal to the eager forward's), ``generate_jit`` (tokens equal to generate's), and the
    engines that replay their programs against engines driven eagerly:
    bf16 on the whole stream (the replaying runs and profile are phases
    serve's and profile_serve's), int8 weights + int8 KV on part of it,
    int4 at 4 layers; tokens equal.  With the measurements: host ops a
    tick, the idle share of a profiled window, tokens/s and TTFT, seconds
    capturing, graph pool bytes and peak memory, each beside the eager
    run's.  Returns the flash launches of one forward_jit replay, as the
    capture recorded them, and the flash_fwd kernels that a profile of one
    replay saw on the card."""
    from tputopo_torch._graphs import Programs
    from tputopo_torch.decode import generate_jit
    from tputopo_torch.model import forward_jit

    t_phase = time.perf_counter()
    prefix, reqs = stream
    rec = {"phase": "compiled", "model": "llama3_8b", "layers": cfg.n_layers}

    # forward_jit: the capture, one counted replay, then both timed.
    progs = Programs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forward_jit(params, tokens, cfg, programs=progs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset(kernels)
    logits = forward_jit(params, tokens, cfg, programs=progs)
    torch.cuda.synchronize()
    fwd_launches = launch_counts(kernels)
    eager = tt.forward(params, tokens, cfg)
    prof = device_profile("forward_jit", lambda: forward_jit(params, tokens, cfg,
                                                             programs=progs), top=10**6)
    fwd = {"tokens": list(tokens.shape), "first_call_s": first_s,
           "capture_s": progs.capture_seconds, "launches_per_replay": fwd_launches,
           # the device's own count: flash_fwd_sm90 (or _f32) kernel events
           "flash_fwd_kernels_profiled": sum(r["calls"] for r in prof["top"]
                                             if "::flash_fwd_" in r["kernel"]),
           "profiled_replay": {k: prof[k] for k in ("wall_ms", "device_busy_ms")},
           "bitwise_equal": bool(torch.equal(logits, eager)),
           "max_abs_vs_forward": (logits - eager).abs().max().item(),
           "pool_bytes": pool_bytes(progs.pool)}
    del logits, eager
    fwd["replay_ms"] = cuda_ms(lambda: forward_jit(params, tokens, cfg, programs=progs),
                               launches=3, reps=3, warmup=1)
    fwd["eager_ms"] = cuda_ms(lambda: tt.forward(params, tokens, cfg),
                              launches=3, reps=3, warmup=1)
    progs.release()
    rec["forward_jit"] = fwd

    # generate_jit against generate.
    progs = Programs()
    first = generate_jit(params, prompt, cfg, max_new=GEN_NEW, programs=progs)
    torch.cuda.synchronize()
    times = {}
    for name, fn in (("generate_jit", lambda: generate_jit(params, prompt, cfg,
                                                           max_new=GEN_NEW, programs=progs)),
                     ("generate", lambda: tt.generate(params, prompt, cfg, max_new=GEN_NEW))):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (out, time.perf_counter() - t0)
    new = GEN_BATCH * GEN_NEW
    rec["generate_jit"] = {
        "batch": GEN_BATCH, "prompt": GEN_PROMPT, "max_new": GEN_NEW,
        "equal_to_generate": bool(torch.equal(times["generate_jit"][0], times["generate"][0])
                                  and torch.equal(first, times["generate"][0])),
        "new_tokens_per_s": new / times["generate_jit"][1],
        "generate_new_tokens_per_s": new / times["generate"][1],
        "capture_s": progs.capture_seconds, "pool_bytes": pool_bytes(progs.pool)}
    progs.release()

    # The engines: replayed against eager-driven, on the same requests.
    eager_cls = eager_engine(tt.ServingEngine)
    state = card_state()
    eager_run = run_engine(tt, params, cfg, prefix, reqs, make=lambda cb: eager_cls(
        params, cfg, on_tokens=cb, **SERVE_ENGINE))

    def summary(run):
        return {k: run[k] for k in ("wall_s", "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
                                    "peak_mem_gb", "programs")}

    rec["serve_bf16"] = {"requests": len(reqs), "generated": eager_run["generated"],
                         "equal_tokens": all(r["rows"] == eager_run["rows"]
                                             for r in serve_runs),
                         "replayed": [summary(r) for r in serve_runs],
                         "eager": summary(eager_run), "card_state_before": state}
    rec["ops"] = {"replayed": ops_per_tick(tt.ServingEngine, params, cfg),
                  "eager": ops_per_tick(eager_cls, params, cfg)}
    idle = {"replayed": serve_profile,
            "eager": profile_serve(tt, params, cfg, prefix, reqs, eager_cls, "serve_eager")}
    rec["profile_window"] = {k: {f: v[f] for f in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "decode_steps", "prefill_chunks")}
                             for k, v in idle.items()}

    qp = tt.quantize_params(params, bits=8)
    qcfg = dataclasses.replace(cfg, kv_dtype="int8")
    q_reqs = reqs[:COMPILED_INT8_REQUESTS]
    runs = [run_engine(tt, qp, qcfg, prefix, q_reqs, make=lambda cb, cls=cls: cls(
        qp, qcfg, on_tokens=cb, **SERVE_ENGINE)) for cls in (tt.ServingEngine, eager_cls)]
    del qp
    rec["serve_int8"] = {"requests": len(q_reqs), "generated": runs[1]["generated"],
                         "equal_tokens": runs[0]["rows"] == runs[1]["rows"],
                         "replayed": summary(runs[0]), "eager": summary(runs[1])}

    cfg4 = dataclasses.replace(cfg, n_layers=SERVE_INT4_LAYERS)
    cut = dict(params, layers={k: v[:SERVE_INT4_LAYERS] for k, v in params["layers"].items()})
    qp4 = tt.quantize_params(cut, bits=4, group_size=SERVE_INT4_GROUP)
    p4, r4 = serve_stream(cfg.vocab_size, 6, SERVE_INT4_REQUESTS, SERVE_INT4_PROMPT,
                          SERVE_INT4_NEW, every=2)
    runs = [run_engine(tt, qp4, cfg4, p4, r4, make=lambda cb, cls=cls: cls(
        qp4, cfg4, on_tokens=cb, **SERVE_ENGINE)) for cls in (tt.ServingEngine, eager_cls)]
    del qp4
    rec["serve_int4"] = {"layers": SERVE_INT4_LAYERS, "requests": len(r4),
                         "equal_tokens": runs[0]["rows"] == runs[1]["rows"],
                         "replayed": summary(runs[0]), "eager": summary(runs[1])}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(fwd_launches["flash_fwd"] == cfg.n_layers,
          f"forward_jit launched flash_fwd {fwd_launches['flash_fwd']} times a replay, "
          f"want {cfg.n_layers}")
    check(fwd["flash_fwd_kernels_profiled"] == cfg.n_layers,
          f"the profile of one forward_jit replay holds "
          f"{fwd['flash_fwd_kernels_profiled']} flash_fwd kernels, want {cfg.n_layers}")
    check(fwd["bitwise_equal"], f"forward_jit's logits differ from forward's: {fwd}")
    check(rec["generate_jit"]["equal_to_generate"], "generate_jit differs from generate")
    for name in ("serve_bf16", "serve_int8", "serve_int4"):
        check(rec[name]["equal_tokens"],
              f"compiled {name}: the replayed engine's tokens differ from the eager one's")
    check(rec["ops"]["replayed"]["decode_tick"] < rec["ops"]["eager"]["decode_tick"],
          f"a replayed decode tick dispatched as many ops as an eager one: {rec['ops']}")
    return fwd_launches, fwd["flash_fwd_kernels_profiled"]


def phase_compiled_moe(tt, params, cfg) -> None:
    """The MoE engine (Mixtral width) replaying its programs against one
    driven eagerly, on moe_decode_serve's stream: tokens equal."""
    t_phase = time.perf_counter()
    prefix, reqs = serve_stream(cfg.vocab_size, 7, MOE_SERVE_REQUESTS, SERVE_PROMPT,
                                SERVE_NEW, 3)
    eager_cls = eager_engine(tt.ServingEngine)
    runs = [run_engine(tt, params, cfg, prefix, reqs, make=lambda cb, cls=cls: cls(
        params, cfg, on_tokens=cb, **SERVE_ENGINE)) for cls in (tt.ServingEngine, eager_cls)]
    rec = {"phase": "compiled_moe", "model": "mixtral_8x7b", "layers": cfg.n_layers,
           "requests": len(reqs), "equal_tokens": runs[0]["rows"] == runs[1]["rows"]}
    for name, run in zip(("replayed", "eager"), runs):
        rec[name] = {k: run[k] for k in ("wall_s", "tokens_per_s", "ttft_p50_s",
                                         "peak_mem_gb", "programs")}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["equal_tokens"], "compiled_moe: the replayed engine's tokens differ "
                               "from the eager one's")


def phase_spec_generate(tt, kernels, params, cfg) -> dict:
    """Speculative decoding of one sequence over the 32-layer weights, bf16:
    every pick within GEN_GAP of the forward's max, the accounting identity,
    no flash launch; beside it greedy generate's tokens and time.  Then the
    f32 case, lossless: 2 layers at full width over the f32 masters, equal
    to greedy generate token for token, every gap within SPEC_F32_GAP.
    Returns the flash launches of the bf16 run."""
    from tputopo_torch.speculative import spec_generate

    t_phase = time.perf_counter()
    prompt = torch.randint(0, cfg.vocab_size, (1, SPEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(9))
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = spec_generate(params, prompt, cfg, max_new=SPEC_NEW,
                               draft_layers=SPEC_DRAFT_LAYERS, gamma=SPEC_GAMMA)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    t0 = time.perf_counter()
    greedy = tt.generate(params, prompt, cfg, max_new=SPEC_NEW)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    check(tuple(out.shape) == (1, SPEC_PROMPT + SPEC_NEW), f"spec shape {tuple(out.shape)}")
    check(bool(torch.equal(out[:, :SPEC_PROMPT], prompt)), "spec_generate changed the prompt")
    vs = picks_vs_forward(tt, params, cfg, [out[0].tolist()], [SPEC_PROMPT])
    same = int((out[0, SPEC_PROMPT:] == greedy[0, SPEC_PROMPT:]).sum())
    steps, acc = stats["target_steps"], stats["drafted_accepted"]

    # f32: the masters' first layers, sliced (views), computed in f32.
    cfg32 = dataclasses.replace(cfg, n_layers=SPEC_F32_LAYERS, compute_dtype=torch.float32)
    cut = dict(params, layers={k: v[:SPEC_F32_LAYERS] for k, v in params["layers"].items()})
    out32, stats32 = spec_generate(cut, prompt, cfg32, max_new=SPEC_NEW,
                                   draft_layers=SPEC_F32_LAYERS - 1, gamma=SPEC_GAMMA)
    greedy32 = tt.generate(cut, prompt, cfg32, max_new=SPEC_NEW)
    vs32 = picks_vs_forward(tt, cut, cfg32, [out32[0].tolist()], [SPEC_PROMPT])
    rec = {"phase": "spec_generate", "model": "llama3_8b", "layers": cfg.n_layers,
           "compute": "bf16", "draft_layers": SPEC_DRAFT_LAYERS, "gamma": SPEC_GAMMA,
           "prompt": SPEC_PROMPT, "max_new": SPEC_NEW, **stats,
           "tokens_per_target_step": SPEC_NEW / steps, "wall_s": spec_s,
           "generate_wall_s": greedy_s, "tokens_equal_to_generate": same,
           "launches": launches, **vs, "bound_max_gap": GEN_GAP,
           "f32": {"layers": SPEC_F32_LAYERS, "draft_layers": SPEC_F32_LAYERS - 1,
                   **stats32, "equal_to_generate": bool(torch.equal(out32, greedy32)),
                   **vs32, "bound_max_gap": SPEC_F32_GAP},
           "note": "random weights: not a speed result of speculation",
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"spec_generate: a pick is off the forward's greedy pick: {vs}")
    check(steps + acc in (SPEC_NEW, SPEC_NEW + 1),
          f"spec_generate: target_steps {steps} + drafted_accepted {acc} not in "
          f"{{{SPEC_NEW}, {SPEC_NEW + 1}}}")
    check(not any(launches.values()), f"spec_generate launched a flash kernel: {launches}")
    check(rec["f32"]["equal_to_generate"] and vs32["vs_forward_max_gap"] <= SPEC_F32_GAP,
          f"spec_generate at f32 is not greedy generate: {rec['f32']}")
    return launches


def phase_spec_serve(tt, kernels, params, cfg) -> dict:
    """The speculative engine and the plain one on the same 8 requests, no
    prefix: every request its budget, every pick within GEN_GAP of the
    forward, no flash launch, 0 <= drafted_accepted <= generated; tokens/s,
    TTFT, target streams and the share of equal tokens for both.  Returns
    the speculative run's flash launches, the run and its requests."""
    from tputopo_torch.speculative import SpecServingEngine

    t_phase = time.perf_counter()
    _, stream = serve_stream(cfg.vocab_size, 5, SPEC_SERVE_REQUESTS, SERVE_PROMPT,
                             (SPEC_SERVE_NEW, SPEC_SERVE_NEW), every=3)
    reqs = [(p, m, False) for p, m, _ in stream]
    reset(kernels)
    spec = run_engine(tt, params, cfg, None, reqs, make=lambda cb: SpecServingEngine(
        params, cfg, on_tokens=cb, **SPEC_ENGINE))
    launches = launch_counts(kernels)
    plain = run_engine(tt, params, cfg, None, reqs)
    check_rows(spec["rows"], spec["plens"], reqs, None, cfg.vocab_size, "spec_serve")
    check_rows(plain["rows"], plain["plens"], reqs, None, cfg.vocab_size, "spec_serve plain")
    vs = picks_vs_forward(tt, params, cfg, spec["rows"], spec["plens"])
    equal = sum(a == b for ra, rb, n in zip(spec["rows"], plain["rows"], spec["plens"])
                for a, b in zip(ra[n:], rb[n:]))

    def summary(run):
        steps = run["metrics"]["decode_steps"]
        return {"tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
                "ttft_p50_s": run["ttft_p50_s"], "ttft_p95_s": run["ttft_p95_s"],
                "generated": run["generated"], "decode_steps": steps,
                "tokens_per_target_stream": run["generated"] / steps,
                "metrics": run["metrics"]}

    accepted = spec["metrics"]["drafted_accepted"]
    rec = {"phase": "spec_serve", "model": "llama3_8b", "layers": cfg.n_layers,
           "engine": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in SPEC_ENGINE.items()},
           "requests": len(reqs), "max_new": SPEC_SERVE_NEW,
           "prompt_tokens": sum(spec["plens"]), "spec": summary(spec),
           "plain": summary(plain), "equal_token_share": equal / spec["generated"],
           "launches": launches, **vs, "bound_max_gap": GEN_GAP,
           "note": "random weights: not a speed result of speculation",
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"spec_serve: a pick is off the forward's greedy pick: {vs}")
    check(not any(launches.values()), f"spec_serve launched a flash kernel: {launches}")
    check(0 <= accepted <= spec["generated"],
          f"spec_serve: drafted_accepted {accepted} outside [0, {spec['generated']}]")
    return launches, spec, reqs


def phase_lora_serve(tt, kernels, params, cfg) -> dict:
    """LoRA serving over the 32-layer weights, rank LORA_RANK on wq and wv:
    a zero-b adapter gives the base engine's tokens bit for bit; a nonzero
    adapter through lora_view, every pick within GEN_GAP of the merged
    weights' forward; QLoRA (int8 base, int8 KV cache, the same adapter)
    within SERVE_INT8_GAP of the dequantized twin's forward.  The adapter
    must show in what is served: some of its tokens differ from the base
    engine's, and the base's picks sit further off the merged forward than
    the adapter's do (an engine that dropped the delta would serve the
    base's tokens and read the same gap).  No flash launch in the three
    adapter runs, which are the only work counted.  Returns their
    launches."""
    from tputopo_torch import lora
    from tputopo_torch.quant import deq, is_quantized

    t_phase = time.perf_counter()
    _, stream = serve_stream(cfg.vocab_size, 7, LORA_REQUESTS, LORA_PROMPT, LORA_NEW,
                             every=2)
    reqs = [(p, m, False) for p, m, _ in stream]
    zero = lora.init_lora(cfg, 11, rank=LORA_RANK)
    adapter = lora.init_lora(cfg, 11, rank=LORA_RANK)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for ad in adapter["layers"].values():
        ad["b"].normal_(0.0, LORA_B_STD, generator=gen)

    base_run = run_engine(tt, params, cfg, None, reqs)
    reset(kernels)
    zero_run = run_engine(tt, lora.lora_view(params, zero), cfg, None, reqs)
    view_run = run_engine(tt, lora.lora_view(params, adapter), cfg, None, reqs)
    launches = launch_counts(kernels)
    check_rows(view_run["rows"], view_run["plens"], reqs, None, cfg.vocab_size, "lora_serve")
    merged = lora.merge_lora(params, adapter)
    vs = picks_vs_forward(tt, merged, cfg, view_run["rows"], view_run["plens"])
    vs_base = picks_vs_forward(tt, merged, cfg, base_run["rows"], base_run["plens"])
    del merged
    changed = sum(a != b for ra, rb, n in zip(view_run["rows"], base_run["rows"],
                                              view_run["plens"])
                  for a, b in zip(ra[n:], rb[n:]))
    qcfg = dataclasses.replace(cfg, kv_dtype="int8")
    qbase = tt.quantize_params(params, bits=8)
    reset(kernels)
    q_run = run_engine(tt, lora.lora_view(qbase, adapter), qcfg, None, reqs)
    launches = {k: n + launches[k] for k, n in launch_counts(kernels).items()}
    check_rows(q_run["rows"], q_run["plens"], reqs, None, cfg.vocab_size, "lora_serve int8")

    def twin(t):
        """The int8 tree dequantized in f32 and held at the compute dtype,
        to which the forward casts every matmul weight: its forward is an
        f32 twin's.  Stacked leaves go one layer at a time (an f32 copy of
        w_gate alone is 7.5 GB)."""
        if not is_quantized(t):
            return {k: twin(v) for k, v in t.items()} if isinstance(t, dict) else t
        q = t["int8"]
        if q.dim() < 3:
            return deq(t, torch.float32).to(cfg.compute_dtype)
        out = torch.empty(q.shape, dtype=cfg.compute_dtype, device=q.device)
        for i in range(q.shape[0]):
            out[i] = deq({k: v[i] for k, v in t.items()}, torch.float32)
        return out

    dq = twin(qbase)
    del qbase
    vs_q = picks_vs_forward(tt, lora.lora_view(dq, adapter), cfg, q_run["rows"],
                            q_run["plens"])
    del dq
    rec = {"phase": "lora_serve", "model": "llama3_8b", "layers": cfg.n_layers,
           "rank": LORA_RANK, "targets": list(lora.DEFAULT_TARGETS),
           "b_std": LORA_B_STD, "requests": len(reqs),
           "zero_b_equals_base": zero_run["rows"] == base_run["rows"],
           "tokens_per_s": {"base": base_run["tokens_per_s"],
                            "zero_b": zero_run["tokens_per_s"],
                            "adapter": view_run["tokens_per_s"],
                            "qlora_int8": q_run["tokens_per_s"]},
           "adapter_vs_merged": {**vs, "bound_max_gap": GEN_GAP},
           "base_vs_merged": vs_base,
           "adapter_changed_token_share": changed / view_run["generated"],
           "qlora_vs_dequantized_twin": {**vs_q, "bound_max_gap": SERVE_INT8_GAP},
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(rec["zero_b_equals_base"], "lora_serve: a zero-b adapter changed the tokens")
    check(vs["vs_forward_max_gap"] <= GEN_GAP,
          f"lora_serve: a pick is off the merged weights' forward: {vs}")
    check(changed > 0 and vs_base["vs_forward_max_gap"] > vs["vs_forward_max_gap"],
          f"lora_serve: the adapter does not show in the served tokens: {changed} "
          f"changed, base picks vs merged {vs_base}, adapter's {vs}")
    check(vs_q["vs_forward_max_gap"] <= SERVE_INT8_GAP,
          f"lora_serve: a QLoRA pick is off the dequantized twin's forward: {vs_q}")
    check(not any(launches.values()), f"lora_serve launched a flash kernel: {launches}")
    return launches


def lora_setup(tt):
    """The adapter's training shape: the base at TRAIN_LAYERS from seed 0
    (f32, frozen) and the tokens of phase train.  The adapter is drawn
    from seed 1."""
    cfg = dataclasses.replace(tt.ModelConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    base = tt.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    return cfg, base, tokens


def phase_lora_train(tt, kernels) -> tuple:
    """The adapter's step at the training shape: step 1's loss equals the
    base's loss_fn bit for bit (b = 0), the loss falls over
    LORA_TRAIN_STEPS steps, 8/4/4 launches each step, the frozen base's
    leaf sums unchanged bit for bit.  Returns (launches of the last step,
    (loss, the state's fingerprint) after each step, the steps' ms)."""
    from tputopo_torch import lora
    from tputopo_torch import train as tr

    cfg, base, tokens = lora_setup(tt)
    adapter = lora.init_lora(cfg, 1, rank=LORA_RANK)
    state = tr.TrainState(params=adapter, opt_state=tr.make_optimizer(TRAIN_LR).init(adapter),
                          step=torch.zeros((), dtype=torch.int32, device="cuda"))
    before = leaf_sums(base)
    with torch.no_grad():
        base_loss = tr.loss_fn(base, tokens, cfg).item()
    want = {"flash_fwd": 2 * TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS}
    losses, step_ms, trace = [], [], []
    torch.cuda.reset_peak_memory_stats()
    state_before = card_state()
    for _ in range(LORA_TRAIN_STEPS):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = lora.lora_train_step(state, base, tokens, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts(kernels)
        check(launches == want, f"lora step launched {launches}, want {want}")
        losses.append(loss.item())
        trace.append((loss.item(), fingerprint(state)))
    after = leaf_sums(base)
    rec = {"phase": "lora_train", "model": "llama3_8b", "layers": TRAIN_LAYERS,
           "tokens": [1, TRAIN_SEQ], "remat": cfg.remat, "lr": TRAIN_LR,
           "rank": LORA_RANK, "targets": list(lora.DEFAULT_TARGETS),
           "adapter_params": sum(p.numel() for p in tr._leaves(state.params)),
           "base_params": sum(p.numel() for p in tr._leaves(base)),
           "losses": losses, "base_loss_fn": base_loss,
           "step1_equals_base_loss": losses[0] == base_loss,
           "base_unchanged": after == before,
           "base_requires_grad": any(p.requires_grad for p in tr._leaves(base)),
           "step_ms": step_ms, "launches_per_step": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card_state_before": state_before}
    emit(rec)
    check(all(map(math.isfinite, losses)), f"lora loss not finite: {losses}")
    check(rec["step1_equals_base_loss"],
          f"lora step 1's loss {losses[0]} is not the base's {base_loss}")
    check(losses[-1] < losses[0], f"lora loss did not fall: {losses}")
    check(rec["base_unchanged"] and not rec["base_requires_grad"],
          "lora training wrote or differentiated the frozen base")
    emit(device_profile("lora_train_step", lambda: lora.lora_train_step(
        state, base, tokens, cfg, lr=TRAIN_LR)))
    return launches, trace, step_ms


def phase_sharded_lora_world1(tt, kernels, first) -> dict:
    """make_sharded_lora_state's layout and one make_sharded_lora_train_step
    on {dp: 1, tp: 1} over the world-1 NCCL group, from phase lora_train's
    seeds: the loss and the state's fingerprint equal lora_train_step's
    bit for bit.  Returns its launches."""
    from tputopo_torch import lora
    from tputopo_torch import sharding as sh

    cfg, base, tokens = lora_setup(tt)
    plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cuda")
    sharded = lora.make_sharded_lora_state(plan, cfg, 1, rank=LORA_RANK, lr=TRAIN_LR)
    step = lora.make_sharded_lora_train_step(plan, cfg, sharded.params, lr=TRAIN_LR)
    reset(kernels)
    t0 = time.perf_counter()
    sharded, loss = step(sharded, base, sh.local_batch(plan, tokens))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(kernels)
    got = fingerprint(sharded)
    ref_loss, ref = first
    diff = sorted(n for n in ref if got[n] != ref[n])
    rec = {"phase": "sharded_lora_world1", "layers": TRAIN_LAYERS, "mesh": plan.axes,
           "backend": "nccl", "step_ms": step_ms, "launches_per_step": launches,
           "loss": loss.item(), "lora_train_step_loss": ref_loss,
           "leaves_compared": len(ref), "leaves_differing": diff}
    emit(rec)
    check(loss.item() == ref_loss and not diff,
          f"world-1 sharded lora step differs from lora_train_step: {rec}")
    return launches


# ---- the last compiled programs: the speculative ones and the training steps

def replay_calls(step, state, args, kernels, trace) -> tuple:
    """COMPILED_CALLS calls of a jitted training step, ``step(state, *args)``:
    each call's ms, kernel launches (the first call's from its warm-up, run
    eagerly; a replay's as its capture recorded them), loss, and the leaves
    of the state's fingerprint that differ from ``trace``'s, the eager
    steps' (loss, fingerprint) from the same seed.  Returns (the state, the
    record, with the program's captures, replays, capture seconds, pool
    bytes and the calls' peak memory, allocated and reserved)."""
    calls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(COMPILED_CALLS):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts(kernels)
        got = fingerprint(state)
        ref_loss, ref = trace[i]
        calls.append({"ms": ms, "launches": launches, "loss": loss.item(),
                      "eager_loss": ref_loss,
                      "leaves_differing": sorted(n for n in ref if got[n] != ref[n])})
    progs = step.programs
    rec = {"calls": calls, "first_call_ms": calls[0]["ms"],
           "replay_ms": [c["ms"] for c in calls[1:]], "leaves_compared": len(trace[0][1]),
           "captures": dict(progs.captures), "replays": dict(progs.replays),
           "capture_s": progs.capture_seconds, "pool_bytes": pool_bytes(progs.pool),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           # the pool's segments are reserved, not allocated, between replays
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    return state, rec


def check_replay_calls(what: str, rec: dict, layers: int) -> None:
    """Every call bit for bit the eager step of its index, 2·L/L/L
    launches each, one capture and COMPILED_CALLS - 1 replays."""
    want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    for i, c in enumerate(rec["calls"], start=1):
        check(c["loss"] == c["eager_loss"] and not c["leaves_differing"],
              f"{what}: call {i} is not eager step {i} bit for bit: {c}")
        check(c["launches"] == want, f"{what}: call {i} launched {c['launches']}, want {want}")
    name = next(iter(rec["captures"]), None)
    check(rec["captures"] == {name: 1} and rec["replays"] == {name: COMPILED_CALLS - 1},
          f"{what}: captures {rec['captures']}, replays {rec['replays']}")


def release(step) -> None:
    """Drop a step's graphs and give their pool back to the card."""
    step.programs.release()
    gc.collect()
    torch.cuda.empty_cache()


def phase_compiled_train(tt, kernels, tokens, trace, eager_ms) -> dict:
    """make_sharded_train_step's program on {dp: 1, tp: 1} over the world-1
    NCCL group at the training shape, from phase train's seed: COMPILED_CALLS
    calls, the first the warm-up (which does the step in place) and the
    capture, then replays; each call's loss and fingerprint bit for bit
    eager train_step's, 8/4/4 launches each, one capture.  Replayed ms
    beside phase train's eager ms, capture seconds, pool bytes, peak
    memory.  Then the MoE model at Mixtral width, COMPILED_MOE_LAYERS deep,
    through the same program against its eager train_step.  Returns the
    launches of the dense step's last replay."""
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr

    t_phase = time.perf_counter()
    plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cuda")
    cfg = model_config(tt, "llama3_8b", TRAIN_LAYERS)
    state = tr.make_sharded_state(plan, cfg, 0, lr=TRAIN_LR)
    step = tr.make_sharded_train_step(plan, cfg, lr=TRAIN_LR)
    state, dense = replay_calls(step, state, (sh.local_batch(plan, tokens),), kernels,
                                trace)
    dense.update(model="llama3_8b", layers=TRAIN_LAYERS, tokens=list(tokens.shape),
                 eager_train_step_ms=eager_ms)
    del state
    release(step)

    mcfg = model_config(tt, "mixtral_8x7b", COMPILED_MOE_LAYERS)
    mtokens = torch.randint(0, mcfg.vocab_size, (1, MOE_SEQ), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(8))
    eager = tt.make_train_state(mcfg, 0, lr=TRAIN_LR)
    mtrace, meager_ms = [], []
    for _ in range(COMPILED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager, loss = tt.train_step(eager, mtokens, mcfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        meager_ms.append((time.perf_counter() - t0) * 1e3)
        mtrace.append((loss.item(), fingerprint(eager)))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    state = tr.make_sharded_state(plan, mcfg, 0, lr=TRAIN_LR)
    step = tr.make_sharded_train_step(plan, mcfg, lr=TRAIN_LR)
    state, moe = replay_calls(step, state, (mtokens,), kernels, mtrace)
    moe.update(model="mixtral_8x7b", layers=COMPILED_MOE_LAYERS, tokens=[1, MOE_SEQ],
               eager_train_step_ms=meager_ms)
    del state
    release(step)
    rec = {"phase": "compiled_train", "mesh": plan.axes, "backend": "nccl",
           "dense": dense, "moe": moe, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check_replay_calls("compiled_train", dense, TRAIN_LAYERS)
    check_replay_calls("compiled_train moe", moe, COMPILED_MOE_LAYERS)
    return dense["calls"][-1]["launches"]


def phase_compiled_lora(tt, kernels, trace, eager_ms) -> dict:
    """make_sharded_lora_train_step's program on {dp: 1, tp: 1} over the
    world-1 NCCL group at the training shape, from phase lora_train's
    seeds: COMPILED_CALLS calls, each bit for bit eager lora_train_step's,
    8/4/4 launches each, one capture.  Then the same over the QLoRA base,
    grouped int4 (group 128), on the tokens' first QLORA_INT4_SEQ, against
    its own eager steps.  Returns the launches of the raw-base step's last
    replay."""
    from tputopo_torch import lora
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr

    t_phase = time.perf_counter()
    cfg, base, tokens = lora_setup(tt)
    plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cuda")
    state = lora.make_sharded_lora_state(plan, cfg, 1, rank=LORA_RANK, lr=TRAIN_LR)
    step = lora.make_sharded_lora_train_step(plan, cfg, state.params, lr=TRAIN_LR)
    state, raw = replay_calls(step, state, (base, sh.local_batch(plan, tokens)), kernels,
                              trace)
    raw.update(base="f32", tokens=list(tokens.shape), eager_lora_train_step_ms=eager_ms)
    del state
    release(step)

    q4 = tt.quantize_params(base, bits=4, group_size=SERVE_INT4_GROUP)
    del base
    short = tokens[:, :QLORA_INT4_SEQ]
    adapter = lora.init_lora(cfg, 1, rank=LORA_RANK)
    eager = tr.TrainState(params=adapter,
                          opt_state=tr.make_optimizer(TRAIN_LR).init(adapter),
                          step=torch.zeros((), dtype=torch.int32, device="cuda"))
    qtrace, qeager_ms = [], []
    for _ in range(COMPILED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager, loss = lora.lora_train_step(eager, q4, short, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        qeager_ms.append((time.perf_counter() - t0) * 1e3)
        qtrace.append((loss.item(), fingerprint(eager)))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    state = lora.make_sharded_lora_state(plan, cfg, 1, rank=LORA_RANK, lr=TRAIN_LR)
    step = lora.make_sharded_lora_train_step(plan, cfg, state.params, lr=TRAIN_LR)
    state, qlora = replay_calls(step, state, (q4, short), kernels, qtrace)
    qlora.update(base=f"int4, group {SERVE_INT4_GROUP}", tokens=list(short.shape),
                 eager_lora_train_step_ms=qeager_ms)
    del state, q4
    release(step)
    rec = {"phase": "compiled_lora", "model": "llama3_8b", "layers": TRAIN_LAYERS,
           "rank": LORA_RANK, "mesh": plan.axes, "backend": "nccl", "raw": raw,
           "qlora_int4": qlora, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check_replay_calls("compiled_lora", raw, TRAIN_LAYERS)
    check_replay_calls("compiled_lora int4", qlora, TRAIN_LAYERS)
    return raw["calls"][-1]["launches"]


def phase_compiled_vision(tt) -> None:
    """make_vision_train_step's program on the reference's classifier, bf16,
    batch VISION_BATCH: VISION_STEPS calls against VISION_STEPS steps of its
    eager body (vision_train_step) from the same seed, the losses bit for
    bit; each step's ms on the host clock (a readback ends each), one
    capture and VISION_STEPS - 1 replays."""
    from tputopo_torch import train as tr
    from tputopo_torch import vision as tv

    t_phase = time.perf_counter()
    cfg = tv.VisionConfig()
    images, labels = tv.synthetic_batch(cfg, VISION_BATCH, 0)

    def trace(step):
        params = tv.init_vision_params(cfg, 0)
        opt_state = tr.Adam(lr=1e-3).init(params)
        losses, ms = [], []
        for _ in range(VISION_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    opt = tr.Adam(lr=1e-3)
    eager = trace(lambda p, o: (p, o, tv.vision_train_step(p, o, images, labels, cfg, opt)))
    step, _ = tv.make_vision_train_step(None, cfg, lr=1e-3)
    replayed = trace(lambda p, o: step(p, o, images, labels))
    progs = step.programs
    rec = {"phase": "compiled_vision", "steps": VISION_STEPS, "batch": VISION_BATCH,
           "losses_equal": replayed[0] == eager[0], "losses": replayed[0],
           "replayed_step_ms": statistics.median(replayed[1][1:]),
           "eager_step_ms": statistics.median(eager[1][1:]),
           "first_call_ms": replayed[1][0], "captures": dict(progs.captures),
           "replays": dict(progs.replays), "capture_s": progs.capture_seconds,
           "pool_bytes": pool_bytes(progs.pool), "seconds": time.perf_counter() - t_phase}
    emit(rec)
    release(step)
    check(rec["losses_equal"], f"compiled_vision: losses {replayed[0]} are not the "
                               f"eager body's {eager[0]}")
    check(rec["captures"] == {"vision_train_step": 1}
          and rec["replays"] == {"vision_train_step": VISION_STEPS - 1},
          f"compiled_vision: captures {rec['captures']}, replays {rec['replays']}")


def phase_compiled_spec(tt, params, cfg, spec_run, reqs) -> None:
    """spec_generate replayed (its prefill and verify-step programs) against
    its eager body spec_generate_eager, the sequence of phase spec_generate:
    at bf16 on the 32 layers and at f32 on 2, tokens and stats equal, the
    bf16 picks within GEN_GAP of the forward and the accounting identity,
    the f32 tokens greedy generate's; wall time of both, the verify steps
    replayed, and the host ops and readbacks of a replayed call (one
    readback a round).  Then the speculative engine of phase spec_serve
    (which replayed its programs) against its eager-driven twin on the same
    8 requests: tokens equal, a replayed tick dispatching no host op but
    its one readback; tokens/s and TTFT of both."""
    from tputopo_torch._graphs import Programs
    from tputopo_torch.speculative import (SpecServingEngine, spec_generate,
                                           spec_generate_eager)

    t_phase = time.perf_counter()
    prompt = torch.randint(0, cfg.vocab_size, (1, SPEC_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(9))

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = fn()
        torch.cuda.synchronize()
        return out, stats, time.perf_counter() - t0

    def compare(p, c, draft_layers):
        kw = dict(max_new=SPEC_NEW, draft_layers=draft_layers, gamma=SPEC_GAMMA)
        progs = Programs()
        first = run(lambda: spec_generate(p, prompt, c, programs=progs, **kw))
        replayed = run(lambda: spec_generate(p, prompt, c, programs=progs, **kw))
        with _OpCount() as ops:
            spec_generate(p, prompt, c, programs=progs, **kw)
        eager = run(lambda: spec_generate_eager(p, prompt, c, **kw))
        steps = replayed[1]["target_steps"]
        rec = {"layers": c.n_layers, "draft_layers": draft_layers, "stats": replayed[1],
               "tokens_equal": bool(torch.equal(first[0], eager[0])
                                    and torch.equal(replayed[0], eager[0])),
               "stats_equal": first[1] == replayed[1] == eager[1],
               "replayed_wall_s": replayed[2], "eager_wall_s": eager[2],
               "first_call_s": first[2], "capture_s": progs.capture_seconds,
               "pool_bytes": pool_bytes(progs.pool), "captures": dict(progs.captures),
               "verify_steps_replayed_a_call": progs.replays["spec_step"] // 3,
               "verify_steps": steps - 1, "host_ops_a_call": ops.n,
               "readbacks_a_call": ops.reads,
               "new_tokens_per_s": {"replayed": SPEC_NEW / replayed[2],
                                    "eager": SPEC_NEW / eager[2]}}
        progs.release()
        return rec, replayed[0]

    bf16, out = compare(params, cfg, SPEC_DRAFT_LAYERS)
    bf16.update(picks_vs_forward(tt, params, cfg, [out[0].tolist()], [SPEC_PROMPT]))
    cfg32 = dataclasses.replace(cfg, n_layers=SPEC_F32_LAYERS, compute_dtype=torch.float32)
    cut = dict(params, layers={k: v[:SPEC_F32_LAYERS] for k, v in params["layers"].items()})
    f32, out32 = compare(cut, cfg32, SPEC_F32_LAYERS - 1)
    f32["equal_to_generate"] = bool(torch.equal(
        out32, tt.generate(cut, prompt, cfg32, max_new=SPEC_NEW)))

    eager_cls = eager_engine(SpecServingEngine)
    eager = run_engine(tt, params, cfg, None, reqs, make=lambda cb: eager_cls(
        params, cfg, on_tokens=cb, **SPEC_ENGINE))

    def summary(r):
        return {k: r[k] for k in ("wall_s", "tokens_per_s", "ttft_p50_s", "ttft_p95_s",
                                  "peak_mem_gb", "programs", "metrics")}

    engine = {"requests": len(reqs), "generated": eager["generated"],
              "equal_tokens": spec_run["rows"] == eager["rows"],
              "replayed": summary(spec_run), "eager": summary(eager),
              "ops": {"replayed": ops_per_tick(SpecServingEngine, params, cfg, SPEC_ENGINE),
                      "eager": ops_per_tick(eager_cls, params, cfg, SPEC_ENGINE)}}
    rec = {"phase": "compiled_spec", "model": "llama3_8b", "gamma": SPEC_GAMMA,
           "prompt": SPEC_PROMPT, "max_new": SPEC_NEW, "bf16": bf16, "f32": f32,
           "engine": engine, "bound_max_gap": GEN_GAP,
           "note": "random weights: not a speed result of speculation",
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    steps, acc = bf16["stats"]["target_steps"], bf16["stats"]["drafted_accepted"]
    for name, r in (("bf16", bf16), ("f32", f32)):
        check(r["tokens_equal"] and r["stats_equal"],
              f"compiled_spec {name}: replayed spec_generate differs from its eager body: {r}")
        check(r["captures"] == {"spec_prefill": 1, "spec_step": 1}
              and r["verify_steps_replayed_a_call"] == r["verify_steps"],
              f"compiled_spec {name}: programs {r['captures']}, "
              f"{r['verify_steps_replayed_a_call']} steps replayed a call")
    check(bf16["vs_forward_max_gap"] <= GEN_GAP,
          f"compiled_spec: a pick is off the forward's greedy pick: {bf16}")
    check(steps + acc in (SPEC_NEW, SPEC_NEW + 1),
          f"compiled_spec: target_steps {steps} + drafted_accepted {acc} not in "
          f"{{{SPEC_NEW}, {SPEC_NEW + 1}}}")
    check(f32["equal_to_generate"], f"compiled_spec: f32 is not greedy generate: {f32}")
    check(engine["equal_tokens"],
          "compiled_spec: the replayed speculative engine's tokens differ from the eager one's")
    tick = engine["ops"]["replayed"]
    check(tick["decode_tick"] - tick["decode_tick_readbacks"] == 0
          and tick["decode_tick_readbacks"] == 1,
          f"compiled_spec: a replayed speculative tick dispatched host ops: {engine['ops']}")


def phase_vision(tt) -> None:
    """train_vision on the card in bf16 (the reference CLI's run): the loss
    finite and the last below the first; then the step's time on the same
    batch, after warm-up."""
    from tputopo_torch import vision as tv

    cfg = tv.VisionConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tv.train_vision(None, cfg, steps=VISION_STEPS, batch=VISION_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    params = tv.init_vision_params(cfg, 0)
    step, opt = tv.make_vision_train_step(None, cfg)
    opt_state = opt.init(params)
    images, labels = tv.synthetic_batch(cfg, VISION_BATCH, 0)
    for _ in range(3):
        step(params, opt_state, images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VISION_STEPS):
        step(params, opt_state, images, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / VISION_STEPS
    rec = {"phase": "vision", "config": {"image_size": cfg.image_size,
                                         "widths": list(cfg.widths),
                                         "d_hidden": cfg.d_hidden, "compute": "bf16"},
           "steps": VISION_STEPS, "batch": VISION_BATCH, "losses": losses,
           "train_vision_wall_s": wall, "step_ms": step_ms}
    emit(rec)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"vision: loss not finite or not falling: {losses}")


def cli_in_process(argv) -> dict:
    """``python -m tputopo_torch <argv>`` in this process, stdout and stderr
    captured: its exit code, last JSON line and seconds.  Each run joins and
    leaves its own world-1 group."""
    from tputopo_torch.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(list(argv))
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return {"argv": list(argv), "rc": rc, "seconds": time.perf_counter() - t0,
            "json": json.loads(lines[-1]) if rc == 0 and lines else None,
            "stderr_tail": err.getvalue()[-1500:]}


CLI_IN_PROCESS = {
    "decode_int8": ["decode", "--int8"],
    "serve_spec": ["serve", "--spec-draft-layers", "2"],
    "serve_int4_prefix": ["serve", "--int4", "--prefix-len", "16"],
    "train_vision": ["train-vision", "--steps", "5"],
    # validation exits 2 before any device work
    "serve_spec_prefix": ["serve", "--spec-draft-layers", "2", "--prefix-len", "8"],
    # the reference's errors: plan_mesh refuses 2 stages on one device, and
    # --ep needs --experts
    "train_lora_pp2": ["train", "--lora-rank", "4", "--pp", "2"],
    "train_ep2_dense": ["train", "--ep", "2"],
}
# The exit-2 runs and the message each must print.
CLI_ERRORS = {"serve_spec_prefix": "incompatible with --prefix-len",
              "train_lora_pp2": "pp=2 x ep=1 does not divide 1 devices",
              "train_ep2_dense": "--ep needs --experts"}


def phase_cli_single_gpu() -> dict:
    runs = {name: cli_in_process(argv) for name, argv in CLI_IN_PROCESS.items()}
    emit({"phase": "cli_single_gpu", "runs": runs})
    for name, run in runs.items():
        want = 2 if name in CLI_ERRORS else 0
        check(run["rc"] == want, f"cli {name} exited {run['rc']}, want {want}: "
                                 f"{run['stderr_tail']}")
        if want:
            check(CLI_ERRORS[name] in run["stderr_tail"],
                  f"cli {name}: no {CLI_ERRORS[name]!r} in {run['stderr_tail']!r}")
            continue
        keys = CLI_KEYS[run["argv"][0]] | ({"drafted_accepted"} if name == "serve_spec"
                                           else set())
        check(set(run["json"]) == keys, f"cli {name}: keys {sorted(run['json'])}, "
                                        f"want {sorted(keys)}")
    check(runs["train_vision"]["json"]["last_loss"] < runs["train_vision"]["json"]["first_loss"],
          f"cli train-vision: loss did not fall: {runs['train_vision']['json']}")
    return runs


@contextlib.contextmanager
def routes(mode: str, record: list):
    """Within the block, every MoE routing records its top-k experts into
    ``record`` (``mode="record"``), or takes them, in the recorded order,
    from ``record`` (``mode="replay"``, the gates recomputed from this
    run's router probabilities).  An expert choice near a tie flips under
    bf16 noise and moves that token's output by O(1): replaying the kernel
    run's choices in the einsum run holds the kernels, not the router's
    sensitivity, against the einsum path."""
    from tputopo_torch import moe

    route, topk, calls = moe._route, torch.topk, iter(list(record))

    def wrapped(x32, router, m, plan=None):
        if mode == "record":
            probs = torch.softmax(x32 @ router.float(), dim=-1)
            record.append(topk(probs, m.top_k, dim=-1)[1])
            return route(x32, router, m, plan)
        idx = next(calls)
        torch.topk = lambda probs, k, dim=-1: (probs.gather(-1, idx), idx)
        try:
            return route(x32, router, m, plan)
        finally:
            torch.topk = topk

    moe._route = wrapped
    try:
        yield record
    finally:
        moe._route = route


def route_flip_share(a: list, b: list) -> float:
    """The share of tokens whose top-k expert set differs between two
    recorded runs in any layer."""
    flipped = None
    for x, y in zip(a, b):
        diff = (x.sort(-1).values != y.sort(-1).values).any(-1)
        flipped = diff if flipped is None else flipped | diff
    return flipped.float().mean().item()


def phase_moe_forward(tt, kernels) -> tuple:
    """Mixtral-8x7B width, MOE_FWD_LAYERS layers, tokens [1, 2048]: the
    forward through the flash kernel (one launch a layer), its logits
    against the einsum path with the kernel run's routing replayed, the
    aux; then layer 0's capacity path against the drop-free one (capacity
    factor 4) on the tokens it kept.  Returns (params, config, launches)."""
    from tputopo_torch import moe
    from tputopo_torch.model import _rmsnorm, _use_flash, embed_tokens

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model_config(tt, "mixtral_8x7b", MOE_FWD_LAYERS)
    t0 = time.perf_counter()
    params = tt.init_params(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(5))
    check(_use_flash(cfg, MOE_SEQ, tokens.device), "attn_impl=auto did not pick the kernel")
    tt.forward_with_aux(params, tokens, cfg)  # warm-up
    torch.cuda.synchronize()
    reset(kernels)
    with routes("record", []) as kernel_routes:
        t0 = time.perf_counter()
        logits, aux = tt.forward_with_aux(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    check(launches["flash_fwd"] == cfg.n_layers,
          f"MoE forward launched flash_fwd {launches['flash_fwd']} times, want {cfg.n_layers}")
    check(tuple(logits.shape) == (1, MOE_SEQ, cfg.vocab_size), f"logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "MoE forward logits not finite")
    check(math.isfinite(aux.item()) and aux.item() > 0, f"MoE aux {aux.item()}")

    ecfg = dataclasses.replace(cfg, attn_impl="einsum")
    with routes("replay", kernel_routes):
        t0 = time.perf_counter()
        ref = tt.forward(params, tokens, ecfg)
        torch.cuda.synchronize()
        einsum_s = time.perf_counter() - t0
    with routes("record", []) as free_routes:
        tt.forward(params, tokens, ecfg)
    max_abs = (logits - ref).abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    del ref

    # layer 0's expert layer on the normed embeddings, bf16: the capacity
    # path against the drop-free one
    p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = _rmsnorm(embed_tokens(params, tokens, cfg), params["layers"]["mlp_norm"][0],
                 cfg.norm_eps)
    m = cfg.moe
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    full, _ = moe.moe_mlp(x, p0, roomy)
    atol, rtol = MOE_KEPT_TOL
    drops = {}
    for cf in (m.capacity_factor, MOE_TIGHT_CF):
        tight = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=cf))
        out, _ = moe.moe_mlp(x, p0, tight)
        combine, _ = moe._route(x.float(), p0["router"], tight.moe)
        kept_slots = combine.sum((-1, -2)) > 0  # [B, T, k]
        kept = kept_slots.all(-1)
        err = (out.float() - full.float()).abs()
        drops[cf] = {"capacity": tight.moe.capacity(MOE_SEQ),
                     "dropped_seat_share": 1.0 - kept_slots.float().mean().item(),
                     "kept_token_share": kept.float().mean().item(),
                     "kept_vs_drop_free_max_abs": err[kept].max().item(),
                     "within": bool((err <= atol + rtol * full.float().abs())[kept].all())}
    torch.cuda.synchronize()
    rec = {"phase": "moe_forward", "model": "mixtral_8x7b", "layers": cfg.n_layers,
           "tokens": [1, MOE_SEQ], "experts": m.n_experts, "top_k": m.top_k,
           "capacity_factor": m.capacity_factor, "capacity": m.capacity(MOE_SEQ),
           "init_s": init_s, "forward_s": fwd_s, "einsum_forward_s": einsum_s,
           "launches": launches, "aux": aux.item(),
           "vs_einsum_max_abs": max_abs, "vs_einsum_top1": top1,
           "bound_max_abs": FWD_MAX_ABS, "bound_top1": FWD_TOP1,
           "einsum_routing": "replayed from the kernel run",
           "free_einsum_route_flip_share": route_flip_share(kernel_routes, free_routes),
           "layer0_by_capacity_factor": drops, "kept_tol": {"atol": atol, "rtol": rtol},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(max_abs <= FWD_MAX_ABS and top1 >= FWD_TOP1,
          f"MoE kernel forward disagrees with the einsum path: {rec}")
    check(all(d["within"] for d in drops.values())
          and drops[MOE_TIGHT_CF]["dropped_seat_share"] > 0,
          f"MoE capacity path off the drop-free one on kept tokens: {rec}")
    return params, cfg, launches


@contextlib.contextmanager
def router_logits(record: list):
    """Within the block, every MoE routing (the capacity path's ``_route``
    and the drop-free mixture of decode and serving, the loop's and the
    routed layer's) appends its router logits [B, T, E] (f32) to
    ``record``, in call order."""
    from tputopo_torch import moe

    route, mixture, grouped = moe._route, moe.moe_mlp_reference, moe.moe_mlp_routed

    def logged_route(x32, router, m, plan=None):
        record.append(x32 @ router.float())
        return route(x32, router, m, plan)

    def logged(layer):
        def run(x, p, cfg, **kw):
            record.append(x.float() @ p["router"].float())
            return layer(x, p, cfg, **kw)
        return run

    moe._route, moe.moe_mlp_reference = logged_route, logged(mixture)
    moe.moe_mlp_routed = logged(grouped)
    try:
        yield record
    finally:
        moe._route, moe.moe_mlp_reference, moe.moe_mlp_routed = route, mixture, grouped


def decode_vs_forward(tt, params, cfg, roomy, prompt, new) -> dict:
    """Greedy ``generate`` against the drop-free forward over its tokens,
    with decode's expert choices replayed into the forward, position for
    position (the prefill's, then each step's): the picks' largest gap
    below the forward's max, and the router-logit differences between
    decode and forward (their largest, and the 99.9th percentile: how far
    a routing decision moves between the two computations)."""
    L, k, P = cfg.n_layers, cfg.moe.top_k, prompt.shape[1]
    with router_logits([]) as dec:
        t0 = time.perf_counter()
        gen = tt.generate(params, prompt, cfg, max_new=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(bool(torch.equal(gen[:, :P], prompt)), "MoE generate changed the prompt")
    per_layer = [torch.cat(dec[l::L], dim=1) for l in range(L)]  # [B, P + new - 1, E]
    chosen = [torch.topk(lg, k, dim=-1)[1] for lg in per_layer]
    with routes("replay", chosen), router_logits([]) as fwd:
        full = tt.forward(params, gen[:, :-1], roomy)[:, P - 1:]
    picks = gen[:, P:]
    return {"wall_s": wall, "gen": gen,
            "vs_forward_max_gap": (full.amax(-1) - full.gather(-1, picks[..., None])[..., 0]
                                   ).max().item(),
            "router_logit_max_diff": max((a - b).abs().max().item()
                                         for a, b in zip(per_layer, fwd)),
            "router_logit_q999_diff": torch.quantile(torch.cat(
                [(a - b).abs().flatten() for a, b in zip(per_layer, fwd)]), 0.999).item()}


def moe_picks_vs_forward(tt, params, cfg, rows, plens, delta: float) -> dict:
    """:func:`picks_vs_forward` for an MoE model whose serving run cannot
    be replayed position by position: the gap is held on the picks made
    at positions whose routing is decisive in every layer, the router
    logit of the k-th expert above the next by more than ``4 * delta``
    (``delta`` the 99.9th percentile of decode's router-logit difference
    from the forward), where an expert choice does not flip between the
    two computations.  A flipped choice moves that token's logits by
    O(1): measured on one H100 with free routing, `generate` sat 1.38
    below the forward's max."""
    k = cfg.moe.top_k
    gaps, decisive, hits, total = [], [], 0, 0
    for row, n in zip(rows, plens):
        toks = torch.tensor([row], device=params["final_norm"].device)
        with router_logits([]) as lg:
            full = tt.forward(params, toks[:, :-1], cfg)[0, n - 1:]
        top = [torch.topk(x[0, n - 1:], k + 1, dim=-1).values for x in lg]
        margin = torch.stack([t[:, k - 1] - t[:, k] for t in top]).amin(0)
        picks = toks[0, n:]
        gaps.append(full.amax(-1) - full.gather(-1, picks[:, None])[:, 0])
        decisive.append(margin > 4 * delta)
        hits += int((full.argmax(-1) == picks).sum())
        total += picks.numel()
    gaps, decisive = torch.cat(gaps), torch.cat(decisive)
    return {"vs_forward_max_gap_decisive": gaps[decisive].max().item() if decisive.any()
            else None,
            "decisive_share": decisive.float().mean().item(),
            "vs_forward_max_gap_all": gaps.max().item(), "vs_forward_top1": hits / total}


def routed_rows(x, p, cfg):
    """The routed layer's first steps (moe.moe_mlp_routed) on x [1, T, D]:
    (the pairs' rows sorted by expert [T k, D] bf16, the segments' ends,
    the pairs per expert)."""
    from tputopo_torch import moe

    x2 = x.reshape(-1, x.shape[-1])
    idx = moe._top_k_gates(x2.float(), p["router"], cfg.moe)[1].reshape(-1)
    order = torch.sort(idx, stable=True).indices
    load = torch.bincount(idx, minlength=cfg.moe.n_experts)
    return (x2.to(torch.bfloat16).index_select(0, order // cfg.moe.top_k),
            load.cumsum(0).to(torch.int32), load)


def grouped_bound_ms(pairs: int, hit: int, D: int, F: int, casts: int = 0) -> float:
    """The least time of the three grouped expert products over ``pairs``
    rows: 6 D F flops a pair against the bf16 tables of the ``hit`` experts
    read once and the rows in and out, at the bf16 peak and the HBM
    bandwidth; with ``casts`` experts, also their f32 masters read and the
    bf16 tables written (the layer as serving calls it)."""
    flops = 6.0 * D * F * pairs
    nbytes = 2.0 * (3 * D * F * hit + (3 * D + 3 * F) * pairs) + 18.0 * D * F * casts
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def phase_moe_grouped(tt, params, cfg) -> dict:
    """The routed expert layer (grouped GEMMs over the routed pairs) on
    layer 0 of the MoE weights at each of MOE_GROUPED_TOKENS tokens, the
    last expert given no pair: against the loop over the experts within
    MOE_GROUPED_REL, two calls bitwise equal, three grouped GEMM launches a
    call; then the grouped GEMMs alone, the layer and the loop timed as a
    CUDA graph replays them, against their byte and flop bounds."""
    from tputopo_torch import _kernels, moe

    t_phase = time.perf_counter()
    m, D, F = cfg.moe, cfg.d_model, cfg.d_ff
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    v = torch.randn(D, generator=gen, device="cuda")
    # x carries v, so the last expert's logit sits ~40 below the others'
    p["router"] = p["router"].clone()
    p["router"][:, -1] -= 40.0 * v / v.norm() ** 2
    inputs = {T: (torch.randn((1, T, D), generator=gen, device="cuda") + v).bfloat16()
              for T in MOE_GROUPED_TOKENS}
    cases = []
    for T, x in inputs.items():
        _, _, load = routed_rows(x, p, cfg)
        before = _kernels.GROUPED_MM.launches
        got = moe.moe_mlp_routed(x, p, cfg)
        again = moe.moe_mlp_routed(x, p, cfg)
        loop = moe.moe_mlp_reference(x, p, cfg)
        torch.cuda.synchronize()
        err = (got.float() - loop.float()).abs().max().item()
        rec = {"phase": "moe_grouped_vs_loop", "tokens": T, "load": load.tolist(),
               "max_abs_err": err, "max_rel_err": err / loop.float().abs().max().item(),
               "repeat_bitwise": bool(torch.equal(got, again)),
               "launches": _kernels.GROUPED_MM.launches - before}
        emit(rec)
        check(int(load[-1]) == 0, f"moe_grouped: the last expert got pairs: {rec}")
        check(rec["max_rel_err"] <= MOE_GROUPED_REL, f"moe_grouped: off the loop: {rec}")
        check(rec["repeat_bitwise"], f"moe_grouped: two calls differ: {rec}")
        check(rec["launches"] == 6, f"moe_grouped: {rec['launches']} launches, want 6")
        cases.append(rec)
    tables = [p[n].to(torch.bfloat16) for n in moe.EXPERT_TABLES]
    timing = {}
    for T, x in inputs.items():
        rows, ends, load = routed_rows(x, p, cfg)
        h = torch.zeros((rows.shape[0], F), dtype=torch.bfloat16, device="cuda")

        def gemms():
            moe.grouped_mm(rows, tables[0], ends)
            moe.grouped_mm(rows, tables[1], ends)
            moe.grouped_mm(h, tables[2], ends)

        hit = int((load > 0).sum())
        slow = 4 if T >= 128 else 10
        timing[T] = {"pairs": rows.shape[0], "experts_hit": hit,
                     "grouped_gemms_ms": graph_ms(gemms),
                     "grouped_gemms_bound_ms": grouped_bound_ms(rows.shape[0], hit, D, F),
                     "layer_ms": graph_ms(lambda x=x: moe.moe_mlp_routed(x, p, cfg), slow),
                     "layer_bound_ms": grouped_bound_ms(rows.shape[0], hit, D, F,
                                                        casts=m.n_experts),
                     "loop_ms": graph_ms(lambda x=x: moe.moe_mlp_reference(x, p, cfg), slow)}
        t = timing[T]
        t["grouped_gemms_share_of_bound"] = t["grouped_gemms_bound_ms"] / t["grouped_gemms_ms"]
        t["layer_share_of_bound"] = t["layer_bound_ms"] / t["layer_ms"]
    del tables
    rec = {"phase": "moe_grouped", "model": "mixtral_8x7b", "layer": 0,
           "tolerance_rel": MOE_GROUPED_REL, "cases": cases, "timing": timing,
           "card": card(), "seconds": time.perf_counter() - t_phase}
    emit(rec)
    return rec


def phase_moe_decode_serve(tt, kernels, params, cfg) -> dict:
    """On the MoE weights: greedy generate (decode's routing replayed into
    the drop-free forward, the same weights at capacity factor 4, decode's
    semantics), a ServingEngine stream and int8 weights on part of it,
    every engine pick at a decisive routing against the drop-free forward;
    no flash launch while serving."""
    t_phase = time.perf_counter()
    m = cfg.moe
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    qp = tt.quantize_params(params, bits=8)
    qcfg = dataclasses.replace(cfg, kv_dtype="int8")
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(6))
    launches = {}
    reset(kernels)
    gen = decode_vs_forward(tt, params, cfg, roomy, prompt, GEN_NEW)
    launches["generate"] = launch_counts(kernels)
    gen8 = decode_vs_forward(tt, qp, qcfg, roomy, prompt, GEN_NEW)

    prefix, reqs = serve_stream(cfg.vocab_size, 7, MOE_SERVE_REQUESTS, SERVE_PROMPT,
                                SERVE_NEW, 3)
    reset(kernels)
    tracer = tt.obs.Tracer()
    run = run_engine(tt, params, cfg, prefix, reqs, make=lambda cb: tt.ServingEngine(
        params, cfg, on_tokens=cb, tracer=tracer, **SERVE_ENGINE))
    launches["serve"] = launch_counts(kernels)
    traced = tracer.export()
    # every replay of a program that runs the layers (all but copy_prefix)
    # runs the routed layer in each layer: three grouped GEMMs
    layered = sum(n for k, n in traced["programs"]["replays"].items() if k != "copy_prefix")
    routed = {"grouped_mm_launches": traced["grouped_mm"]["launches"],
              "want": 3 * cfg.n_layers * layered, **traced["moe"]}
    check_rows(run["rows"], run["plens"], reqs, prefix, cfg.vocab_size, "moe_serve")
    vs = moe_picks_vs_forward(tt, params, roomy, run["rows"], run["plens"],
                              gen["router_logit_q999_diff"])
    q_reqs = reqs[:MOE_INT8_REQUESTS]
    reset(kernels)
    qrun = run_engine(tt, qp, qcfg, prefix, q_reqs)
    launches["serve_int8"] = launch_counts(kernels)
    check_rows(qrun["rows"], qrun["plens"], q_reqs, prefix, cfg.vocab_size, "moe_serve_int8")
    qvs = moe_picks_vs_forward(tt, qp, roomy, qrun["rows"], qrun["plens"],
                               gen8["router_logit_q999_diff"])
    del qp
    rec = {"phase": "moe_decode_serve", "model": "mixtral_8x7b", "layers": cfg.n_layers,
           "generate": {"batch": GEN_BATCH, "prompt": GEN_PROMPT, "max_new": GEN_NEW} | {
               k: gen[k] for k in ("wall_s", "vs_forward_max_gap", "router_logit_max_diff",
                                   "router_logit_q999_diff")},
           "generate_int8": {k: gen8[k] for k in ("wall_s", "vs_forward_max_gap",
                                                  "router_logit_max_diff",
                                                  "router_logit_q999_diff")},
           "serve": {k: run[k] for k in ("wall_s", "generated", "tokens_per_s",
                                         "ttft_p50_s", "ttft_p95_s", "metrics")} | vs
           | {"routed_layer": routed},
           "serve_int8": {"requests": len(q_reqs)} | {
               k: qrun[k] for k in ("wall_s", "generated", "tokens_per_s")} | qvs,
           "reference": "forward at capacity factor E / top_k (drop-free); generate's "
                        "routing replayed into it, the engines' picks held where the "
                        "routing is decisive",
           "bound_max_gap": GEN_GAP, "bound_int8_max_gap": SERVE_INT8_GAP,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(gen["vs_forward_max_gap"] <= GEN_GAP
          and vs["decisive_share"] > 0 and vs["vs_forward_max_gap_decisive"] <= GEN_GAP,
          f"MoE decode/serve pick off the drop-free forward: {rec}")
    # the int8 cache moves the router logits further (its q999 above), so
    # few of the four requests' picks may be decisive: held where there are
    check(gen8["vs_forward_max_gap"] <= SERVE_INT8_GAP
          and (qvs["vs_forward_max_gap_decisive"] or 0.0) <= SERVE_INT8_GAP,
          f"MoE int8 pick off its tree's forward: {rec}")
    check(all(v == 0 for k in ("serve", "serve_int8") for v in launches[k].values()),
          f"MoE serving launched a flash kernel: {launches}")
    # the counts grow on the device inside the replays
    check(routed["grouped_mm_launches"] == routed["want"] > 0
          and routed["calls"] * m.top_k <= routed["pairs"]
          and routed["experts_hit"] <= routed["calls"] * m.n_experts
          and routed["device_ns"] > 0,
          f"MoE serving: the routed layer's launches or counts are off: {routed}")
    return launches["serve"]


# The latent-attention phase: DeepSeek-V3's widths, one expert layer (8 of 256
# experts held, the shared expert, the group-limited sigmoid router), the
# vocabulary whole; both forms timed at the deepseekv3.longdoc cell's shapes:
# a prefill chunk at starts (span = start + chunk) and the absorbed decode at
# its 32 slots.
MLA_SLOTS, MLA_MAX_LEN, MLA_CHUNK = 32, 32768, 2048
MLA_CHUNK_STARTS = (0, 6144, 14336, 26624)
# The latent chunk-attention kernel (csrc/latent_chunk_attn.cu) against the
# plain expanded form: both round P to bf16, from f32 exponentials taken
# against other running maxima (a 128-position tile's, a 1024-position
# block's), so a probability may land one bf16 ulp apart; each output is
# rounded to bf16 once.  Elementwise they take the flash forward's bf16
# tolerance (TOL); each query head's 128 outputs ||kernel - plain|| /
# ||plain|| <= LATENT_ROW_REL, which a dropped tile, the diagonal off by one
# and P in e4m3 exceed (tests/test_torch_latent_chunk_attention.py).
LATENT_ROW_REL = 1e-2


def mla_config(tt, layers: int = 1):
    """DeepSeek-V3 at its published widths, ``layers`` expert layers."""
    from tputopo_torch.mla import MLAConfig

    moe = tt.MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1, held=(0, 8),
                       scoring="sigmoid", n_group=8, topk_group=4, routed_scale=2.5)
    return tt.ModelConfig(vocab_size=129280, d_model=7168, n_layers=layers, n_heads=128,
                          n_kv_heads=128, d_ff=18432, max_seq=163840, rope_theta=10000.0,
                          norm_eps=1e-6, moe=moe, mla=MLAConfig.deepseek_v3())


def phase_mla(tt) -> dict:
    """Latent attention at DeepSeek-V3's widths, as captured graphs replay
    it, each beside its least time (the cheaper form's flops at the bf16
    peak or the live rows, q and out at HBM bandwidth): the prefill chunks'
    path over a 2048-token chunk at starts :data:`MLA_CHUNK_STARTS`, reading
    the rows below the chunk's end only: its up-projection GEMM and
    ``csrc/latent_chunk_attn.cu`` (within TOL and :data:`LATENT_ROW_REL` of
    the plain expanded form), the kernel alone, the plain expanded form
    called directly, and SDPA over the same up-projected keys and values (a
    yardstick the port never calls); the absorbed decode form (plain) at
    the cell's 32 slots x 32768 positions, which reads every position.
    Then one expert layer through ``ServingEngine``'s programs, traced:
    ``latent_chunk_attn`` launched, ``decode_attn`` and ``chunk_attn``
    never (their launch counts read around the engine's run), the ``mla``
    counts grown in both forms, the tokens the same on a second run."""
    from tputopo_torch import _kernels, attention
    from tputopo_torch.mla import softmax_scale

    t_phase = time.perf_counter()
    cfg = mla_config(tt)
    m, N = cfg.mla, cfg.n_heads
    R, Dq = m.kv_rank, m.row
    gen = torch.Generator(device="cuda").manual_seed(31)
    bf = torch.bfloat16
    rtol, atol = TOL[bf]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    def least_ms(T, pos, absorbed, upproject=True):
        rows = int((pos + T).sum())
        pairs = int((T * (pos + 1) + T * (T - 1) // 2).sum())
        flops = 2.0 * N * pairs * ((2 * R + m.rope) if absorbed
                                   else (m.nope + m.rope + m.v))
        if not absorbed and upproject:
            flops += 2.0 * R * N * (m.nope + m.v) * rows
        nbytes = 2.0 * (rows * Dq + pos.numel() * T * N * (m.nope + m.rope + m.v))
        return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3

    kv_b = randn(R, N * (m.nope + m.v), scale=R ** -0.5)
    T = MLA_CHUNK
    latent = randn(1, MLA_MAX_LEN, Dq)
    q_nope, q_pe = randn(1, T, N, m.nope), randn(1, T, N, m.rope)
    kernel = _kernels.LATENT_CHUNK_ATTN
    prefill = []
    for start in MLA_CHUNK_STARTS:
        pos = torch.tensor([start], device="cuda")
        span = start + T
        rows, seen = latent[:, :span], start

        def call(span=span, pos=pos):
            return attention.cached_latent_attention(q_nope, q_pe, latent, pos, kv_b, m, span)

        def plain(rows=rows, pos=pos, seen=seen):
            return attention.latent_expanded(q_nope, q_pe, rows, pos, kv_b, m, seen)

        before = kernel.launches
        got, again, ref = call(), call(), plain()
        torch.cuda.synchronize()
        diff = got.float() - ref.float()
        rec = {"phase": "latent_prefill", "shape": [T, MLA_MAX_LEN, N], "start": start,
               "launches": kernel.launches - before,
               "max_err_over_tol": ((diff.abs() / (atol + rtol * ref.float().abs()))
                                    .max().item()),
               "max_row_rel_err": (diff.norm(dim=-1) / ref.float().norm(dim=-1)).max().item(),
               "bound_row_rel": LATENT_ROW_REL,
               "repeat_bitwise": bool(torch.equal(got, again))}
        del got, again, ref, diff
        check(rec["launches"] == 2, f"latent_chunk_attn: {rec['launches']} launches, want 2")
        check(rec["max_err_over_tol"] <= 1.0 and rec["max_row_rel_err"] <= LATENT_ROW_REL,
              f"latent_chunk_attn disagrees with the plain expanded form: {rec}")
        check(rec["repeat_bitwise"], f"latent_chunk_attn: two launches differ: {rec}")
        if start == MLA_CHUNK_STARTS[1]:
            # the plain form's blocks are the same with or without the span
            rec["plain_bitwise_whole_cache"] = bool(torch.equal(
                plain(), attention.latent_expanded(q_nope, q_pe, latent, pos, kv_b, m)))
            check(rec["plain_bitwise_whole_cache"],
                  f"the span changed the plain prefill's output: {rec}")

        # the kernel alone, over the up-projected rows and the scaled q
        q = (torch.cat([q_nope, q_pe], -1).float() * softmax_scale(m)).to(bf)
        kv = torch.matmul(latent[:, :span, :R], kv_b).view(1, span, N, m.nope + m.v)
        out = torch.empty((1, T, N, m.v), dtype=bf, device="cuda")
        args = attention._latent_chunk_launch_args(q, kv, latent, pos, out, span)

        def kernel_alone(args=args):
            attention._call(kernel, args, q.device, "timing")

        # SDPA's layout [B, heads, S, D]: k_pe broadcast to every head
        kt = torch.cat([kv[..., :m.nope], latent[:, :span, None, R:].expand(-1, -1, N, -1)],
                       -1).transpose(1, 2).contiguous()
        vt = kv[..., m.nope:].transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        mask = torch.arange(span, device="cuda") <= start + torch.arange(T, device="cuda")[:, None]
        rec.update({"ms": graph_ms(call, calls=2), "kernel_alone_ms": graph_ms(kernel_alone),
                    "upproject_ms": graph_ms(lambda: torch.matmul(latent[:, :span, :R], kv_b),
                                             calls=4),
                    "plain_ms": graph_ms(plain, calls=2),
                    "least_ms": least_ms(T, pos, False),
                    "kernel_alone_least_ms": least_ms(T, pos, False, upproject=False)})
        try:
            rec["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=1.0), calls=2)
        except RuntimeError as e:  # a yardstick only: the port never calls it
            rec["library_ms"], rec["library_error"] = None, str(e)[:200]
        rec["share_of_least"] = rec["least_ms"] / rec["ms"]
        rec["kernel_alone_share"] = rec["kernel_alone_least_ms"] / rec["kernel_alone_ms"]
        emit(rec)
        prefill.append(rec)
        del q, kv, out, kt, vt, qt, mask, args
    emit({"phase": "latent_prefill_card", "card": card_state(),
          "library": "scaled_dot_product_attention over the up-projected keys (k_pe "
                     "broadcast) and values, boolean mask, the up-projection not timed"})
    del latent, q_nope, q_pe
    gc.collect()
    torch.cuda.empty_cache()

    latent = randn(MLA_SLOTS, MLA_MAX_LEN, Dq)
    pos = torch.linspace(8192, 29000, MLA_SLOTS, device="cuda").long()
    q_nope, q_pe = randn(MLA_SLOTS, 1, N, m.nope), randn(MLA_SLOTS, 1, N, m.rope)
    rec = {"phase": "latent_decode", "shape": [MLA_SLOTS, 1, MLA_MAX_LEN, N],
           "ms": graph_ms(lambda: attention.cached_latent_attention(
               q_nope, q_pe, latent, pos, kv_b, m), calls=2),
           "least_ms": least_ms(1, pos, True), "live_rows": int((pos + 1).sum())}
    rec["share_of_least"] = rec["least_ms"] / rec["ms"]
    emit(rec)
    emit({"phase": "latent_decode_card", "card": card_state()})
    del latent, q_nope, q_pe, kv_b

    params = tt.init_params(cfg, 0)
    lens = [(300, 6), (2100, 9), (4000, 5), (1500, 12)]
    runs = []
    for _ in range(2):
        eng = tt.ServingEngine(params, cfg, slots=4, max_len=8192, prompt_pad=(2048, 4096),
                               prefill_chunk=MLA_CHUNK, steps_per_tick=4,
                               record_routes=True, tracer=tt.obs.Tracer())
        before = {k.name: k.launches for k in _kernels.COUNTED}
        rng = np.random.default_rng(5)
        rids = [eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(), k) for n, k in lens]
        out = eng.run()
        torch.cuda.synchronize()
        launched = {k.name: k.launches - before[k.name] for k in _kernels.COUNTED}
        counts = eng.tracer.export()["mla"]
        runs.append([out[r] for r in rids])
        routes = eng.routes[rids[1]]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rec = {"phase": "mla_serve", "launches": launched, "mla": counts, "prefill": prefill,
           "routes_max_id": int(routes.max()), "routes_dtype": str(routes.dtype),
           "tokens_equal_on_rerun": runs[0] == runs[1],
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(launched[_kernels.DECODE_ATTN.name] == 0 and launched[_kernels.CHUNK_ATTN.name] == 0,
          f"a latent cache reached decode_attn or chunk_attn: {launched}")
    check(launched[kernel.name] > 0 and launched[kernel.name] % cfg.n_layers == 0,
          f"the prefill chunks did not take latent_chunk_attn: {launched}")
    check(counts["decode_calls"] > 0 and counts["prefill_calls"] > 0
          and counts["decode_ns"] > 0 and counts["prefill_ns"] > 0, f"mla counts: {counts}")
    check(rec["tokens_equal_on_rerun"], "the MLA engine's tokens differ between two runs")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_moe_train(tt, kernels) -> dict:
    """Mixtral-8x7B width, MOE_TRAIN_LAYERS layers, tokens [1, 2048]: one
    step's loss (cross-entropy + aux) and grads through the kernels
    against the einsum path (routing replayed), then TRAIN_STEPS AdamW
    steps on one batch, 2·L / L / L launches each, the loss falling."""
    from tputopo_torch import train as tr

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = model_config(tt, "mixtral_8x7b", MOE_TRAIN_LAYERS)
    L = cfg.n_layers
    params = tt.init_params(cfg, 0)
    n_params = sum(p.numel() for p in tr._leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(8))
    with routes("record", []) as kernel_routes:
        loss_k, grads_k = tr.loss_and_grads(params, tokens, cfg)
    with routes("replay", kernel_routes):
        loss_e, grads_e = tr.loss_and_grads(params, tokens,
                                            dataclasses.replace(cfg, attn_impl="einsum"))
    names = tr._leaf_names(params)
    grad_err = {n: ((a - b).norm() / b.norm()).item()
                for n, a, b in zip(names, grads_k, grads_e)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    dloss = abs(loss_k - loss_e).item()
    del grads_k, grads_e, kernel_routes
    torch.cuda.empty_cache()
    vs = {"loss_kernels": loss_k.item(), "loss_einsum": loss_e.item(), "abs_dloss": dloss,
          "grad_norm_rel_err": grad_err, "grads_finite": finite}
    check(finite and dloss <= TRAIN_LOSS_TOL and max(grad_err.values()) <= TRAIN_GRAD_NORM_REL,
          f"MoE kernel-path loss/grads disagree with the einsum path: {vs}")

    state = tr.TrainState(params=params, opt_state=tr.make_optimizer(TRAIN_LR).init(params),
                          step=torch.zeros((), dtype=torch.int32, device="cuda"))
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = tt.train_step(state, tokens, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = launch_counts(kernels)
        check(launches == want, f"MoE train step launched {launches}, want {want}")
        losses.append(loss.item())
    rec = {"phase": "moe_train", "model": "mixtral_8x7b", "layers": L,
           "tokens": [1, MOE_SEQ], "params": n_params, "remat": cfg.remat, "lr": TRAIN_LR,
           "vs_einsum": vs, "bound_abs_dloss": TRAIN_LOSS_TOL,
           "bound_grad_norm_rel": TRAIN_GRAD_NORM_REL, "einsum_routing": "replayed",
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "tokens_per_s": MOE_SEQ / step_s[-1], "launches_per_step": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(all(map(math.isfinite, losses)), f"MoE train loss not finite: {losses}")
    check(losses[-1] < losses[0], f"MoE loss did not fall over {TRAIN_STEPS} steps: {losses}")
    emit(device_profile("moe_train_step",
                        lambda: tt.train_step(state, tokens, cfg, lr=TRAIN_LR)))
    return launches


def phase_train(tt, kernels) -> tuple:
    """Llama-3-8B width, 4 layers, tokens [1, 2048]: one step's loss and
    grads through the kernels against the einsum path, then TRAIN_STEPS
    AdamW steps on one batch.  Returns (state, config, tokens, launches
    of the last step, (loss, fingerprint) after each step, the steps' ms)."""
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
    trace = []  # what the sharded step and its program must reproduce
    for _ in range(TRAIN_STEPS):
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = tt.train_step(state, tokens, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = launch_counts(kernels)
        check(launches == want, f"train step launched {launches}, want {want}")
        losses.append(loss.item())
        trace.append((loss.item(), fingerprint(state)))
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
    return state, cfg, tokens, launches, trace, [t * 1e3 for t in step_s]


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
        reset(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = tr.loss_and_grads(state.params, tokens, pcfg)
        torch.cuda.synchronize()
        rec[policy] = {"loss": loss.item(), "ms": (time.perf_counter() - t0) * 1e3,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": launch_counts(kernels)}
        del grads
        check(rec[policy]["launches"] == {"flash_fwd": n_fwd, "flash_bwd_dq": L,
                                          "flash_bwd_dkv": L},
              f"remat={policy} launched {rec[policy]['launches']}")
    emit(rec)
    for policy in ("dots", "none"):
        check(abs(rec[policy]["loss"] - rec["block"]["loss"]) <= 1e-5,
              f"remat={policy} changed the loss: {rec}")


def leaf_sums(tree, prefix: str = "") -> dict:
    """A float64 sum of every leaf of a tree of tensors, by dotted name."""
    from tputopo_torch import train as tr

    return {prefix + name: torch.sum(leaf, dtype=torch.float64).item()
            for name, leaf in zip(tr._leaf_names(tree), tr._leaves(tree))}


def fingerprint(state) -> dict:
    """The leaf sums of a TrainState (params, both AdamW moments) with its
    count and step: two states with equal fingerprints computed by the
    same code are taken as equal."""
    return {**leaf_sums(state.params, "params."), **leaf_sums(state.opt_state.mu, "mu."),
            **leaf_sums(state.opt_state.nu, "nu."), "count": int(state.opt_state.count),
            "step": int(state.step)}


def _views(shape, gen, dtype):
    """q, k, v and dO of ``shape`` [B, S, N, H] as views the kernels cannot
    read as they are: q transposed from [B, N, S, H], k a head slice of
    [B, S, N + 1, H], v starting one element into its storage, dO a
    strided slice of [B, S, N, 2H]."""
    B, S, N, H = shape
    q = torch.randn((B, N, S, H), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn((B, S, N + 1, H), generator=gen, device="cuda").to(dtype)[:, :, 1:]
    v = torch.randn((B * S * N * H + 1,), generator=gen, device="cuda").to(dtype)[1:]
    do = torch.randn((B, S, N, 2 * H), generator=gen, device="cuda").to(dtype)[..., ::2]
    return q, k, v.view(B, S, N, H), do


def phase_repairs(tt, att, kernels) -> None:
    """The two repaired faults of the flash path.  (1) "auto" picks the
    kernel only for the head dims it takes: a forward at d_model 4096 with
    16 heads (H = 256), one layer, launches no kernel and equals the
    einsum path.  (2) The wrappers take views: the kernels on views at the
    kernel table's shape against their plain versions on the same views."""
    from tputopo_torch.model import _use_flash

    cfg = dataclasses.replace(tt.ModelConfig.llama3_8b(), n_layers=1,
                              n_heads=REPAIR_HEADS)
    check(cfg.head_dim == 256, f"head dim {cfg.head_dim}")
    check(not _use_flash(cfg, TRAIN_SEQ, torch.device("cuda")),
          "auto picked the kernel for head dim 256")
    params = tt.init_params(cfg, 0)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(7))
    reset(kernels)
    logits = tt.forward(params, tokens, cfg)
    launches = launch_counts(kernels)
    ref = tt.forward(params, tokens, dataclasses.replace(cfg, attn_impl="einsum"))
    torch.cuda.synchronize()
    rec = {"phase": "repairs", "head_dim_256": {
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "layers": 1,
        "tokens": [1, TRAIN_SEQ], "launches": launches,
        "finite": bool(torch.isfinite(logits).all()),
        "equals_einsum_path": bool(torch.equal(logits, ref))}}
    del params, logits, ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    shape = (1, TRAIN_SEQ, 32, 128)
    q, k, v, do = _views(shape, gen, torch.bfloat16)
    dense = all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v, do))
    o, lse = att.flash_forward_lse(q, k, v, causal=True, block_q=128, block_kv=128)
    po, plse = att._flash_forward_lse_plain(q, k, v, causal=True)
    got = att.flash_backward(q, k, v, o, lse, do, causal=True, block_q=128, block_kv=128)
    d = att._flash_d(o, do.contiguous())
    want = (att._flash_dq_plain(q, k, v, do, lse, d, causal=True),
            *att._flash_dkv_plain(q, k, v, do, lse, d, causal=True))
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    err = (o.float() - po.float()).abs()
    views = {"shape": list(shape), "dtype": "bfloat16", "operands_dense": dense,
             "o_max_abs_err": err.max().item(),
             "o_within": bool((err <= atol + rtol * po.float().abs()).all()),
             "lse_max_abs_err": (lse - plse).abs().max().item(), "lse_tol": LSE_TOL,
             "bound_norm_rel": BWD_BF16_NORM_REL}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        views[f"{name}_norm_rel_err"] = ((g.float() - w.float()).norm()
                                         / w.float().norm()).item()
    rec["views"] = views
    emit(rec)
    h = rec["head_dim_256"]
    check(h["finite"] and h["equals_einsum_path"] and not any(launches.values()),
          f"repairs: head dim 256 under auto: {h}")
    check(not dense and views["o_within"] and views["lse_max_abs_err"] <= LSE_TOL
          and all(views[f"{n}_norm_rel_err"] <= BWD_BF16_NORM_REL for n in ("dq", "dk", "dv")),
          f"repairs: kernels on views disagree with their plain versions: {views}")


def stream_gbps() -> float:
    """HBM bandwidth of a device-to-device copy of STREAM_BYTES: the bytes
    read plus the bytes written over the copy's time."""
    src = torch.empty(STREAM_BYTES // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), launches=10, reps=5)
    return 2 * STREAM_BYTES / (ms / 1e3) / 1e9


def phase_dist_world1() -> None:
    """A world-1 NCCL group through the gang bootstrap with no gang env;
    the all-reduce measurement over it (one rank: no link is measured);
    the link model's prediction for one GPU (0, as the reference's box
    model gives for one chip); the cost model calibrated from a measured
    HBM stream, the only figure one card can calibrate."""
    import torch.distributed as dist
    from tputopo_torch import linkmodel, validate
    from tputopo_torch.collective import measure_allreduce
    from tputopo_torch.distributed import initialize_from_env

    group = initialize_from_env({}, device="cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1 and group.single,
          f"world-1 group: backend {dist.get_backend()}, world {dist.get_world_size()}")
    res = measure_allreduce(payload_mb=ALLREDUCE_MB, iters=20, warmup=3)
    report = validate.validate_slice("h100:1", payload_mb=ALLREDUCE_MB, iters=10)
    hbm = stream_gbps()
    topo = linkmodel.parse_topology("h100:1")
    cal = validate.calibrate_cost_model(topo, measured_hbm_gbps=hbm)
    rec = {"phase": "dist_world1", "backend": "nccl", "world": 1,
           "allreduce": {**res.to_dict(), "label": "world 1, not a link measurement"},
           "validate": report.to_dict(), "stream_hbm_gbps": hbm,
           "calibrated": dataclasses.asdict(cal),
           "measured_vs_spec": validate.measured_vs_spec(cal, "h100")}
    emit(rec)
    check(report.predicted_gbps == 0.0, f"one GPU predicted {report.predicted_gbps}")
    check(res.n_devices == 1 and res.time_ms > 0, f"world-1 all-reduce: {rec['allreduce']}")
    check(cal.hbm_gbps == hbm and cal.ici_link_gbps == topo.generation.ici_link_gbps,
          f"calibration: {rec['calibrated']}")


def phase_sharded_train_world1(tt, kernels, tokens, first) -> dict:
    """make_sharded_state and one make_sharded_train_step on {dp: 1, tp: 1}
    over the world-1 NCCL group at the training shape, from the seed that
    phase ``train`` started from: the loss and the fingerprint of the
    state after the step equal train_step's bit for bit."""
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr

    cfg = dataclasses.replace(tt.ModelConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cuda")
    t0 = time.perf_counter()
    state = tr.make_sharded_state(plan, cfg, 0, lr=TRAIN_LR)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = tr.make_sharded_train_step(plan, cfg, lr=TRAIN_LR)
    reset(kernels)
    t0 = time.perf_counter()
    state, loss = step(state, sh.local_batch(plan, tokens))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(kernels)
    got = fingerprint(state)
    ref_loss, ref = first
    diff = sorted(n for n in ref if got[n] != ref[n])
    rec = {"phase": "sharded_train_world1", "model": "llama3_8b", "layers": TRAIN_LAYERS,
           "mesh": plan.axes, "backend": "nccl", "tokens": list(tokens.shape),
           "init_s": init_s, "step_ms": step_ms, "launches_per_step": launches,
           "loss": loss.item(), "train_step_loss": ref_loss,
           "leaves_compared": len(ref), "leaves_differing": diff,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(rec)
    want = {"flash_fwd": 2 * TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
            "flash_bwd_dkv": TRAIN_LAYERS}
    check(launches == want, f"sharded step launched {launches}, want {want}")
    check(loss.item() == ref_loss and not diff,
          f"world-1 sharded step differs from train_step: {rec}")
    return launches


def model_config(tt, model: str, layers: int, **kw):
    """Llama-3-8B or Mixtral-8x7B at full width, ``layers`` deep."""
    if model == "llama3_8b":
        return dataclasses.replace(tt.ModelConfig.llama3_8b(), n_layers=layers, **kw)
    from tputopo_torch.moe import MoEConfig

    return tt.ModelConfig(vocab_size=32000, d_model=4096, n_layers=layers, n_heads=32,
                          n_kv_heads=8, d_ff=14336, max_seq=32768, rope_theta=1e6,
                          norm_eps=1e-5, moe=MoEConfig(n_experts=8, top_k=2), **kw)


def tp2_want(name: str, axes: dict, layers: int, rank: int, opts: dict) -> dict:
    """The kernel launches of one rank's step, remat "block": the forward
    kernel twice a layer (the checkpoint's recompute), each backward kernel
    once.  The ring's rank r attends its own chunk and the r before it,
    the causal later ones skipped: r + 1 launches a layer.  A pipeline
    stage runs its L / pp layers once per microbatch forward and once
    recomputing it for the backward, and computes no bubble tick."""
    n = layers
    if name == "sp2_ring":
        n = layers * (rank + 1)
    elif axes.get("pp", 1) > 1:
        n = opts["n_micro"] * layers // axes["pp"]
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def tp2_rank_main(rank: int, workdir: str) -> int:
    """One rank of ``tp2_gloo_cuda``: two processes on the one card over
    gloo.  First gloo's all-reduce SUM and MAX on CUDA tensors; then, for
    each of TP2_CASES, one sharded step from the seed, and in turns (one
    rank at a time, for memory) the single-process loss and grads from the
    same seed and tokens, held against this rank's shards.  The step's
    grads are read back from its first AdamW moment, mu = (1 - b1) * g
    from zeros.  Writes rank<r>.json into ``workdir``."""
    import torch.distributed as dist
    import tputopo_torch as tt
    from tputopo_torch import _kernels
    from tputopo_torch import sharding as sh
    from tputopo_torch import train as tr

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{workdir}/store", 2),
                            rank=rank, world_size=2)
    go = Path(workdir, "go")
    while not go.exists():  # the main process frees the card first
        time.sleep(0.05)
    out = {"rank": rank}
    x = torch.full((4,), float(rank + 1), device="cuda")
    y = x.clone()
    dist.all_reduce(x)
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    out["gloo_cuda"] = {"sum": x.tolist(), "max": y.tolist(),
                        "ok": x.tolist() == [3.0] * 4 and y.tolist() == [2.0] * 4}
    for name, axes, model, layers, shape, opts in TP2_CASES if out["gloo_cuda"]["ok"] else ():
        t_case = time.perf_counter()
        # the autograd graph of the last case (checkpoint frames among it)
        # holds reference cycles: without a collection its states stay
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"case": name, "rank": rank,
                          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                          "reserved_gb": torch.cuda.memory_reserved() / 1e9}), flush=True)
        cfg = model_config(tt, model, layers,
                           **{k: v for k, v in opts.items() if k == "sp_impl"})
        tokens = torch.randint(0, cfg.vocab_size, shape, device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(3))
        plan = sh.build_mesh(axes, device="cuda")
        t0 = time.perf_counter()
        state = tr.make_sharded_state(plan, cfg, 0, lr=TRAIN_LR)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reset(_kernels.FLASH)
        sh.HOST_STAGED.update(calls=0, bytes=0)
        torch.cuda.reset_peak_memory_stats()
        step = tr.make_sharded_train_step(plan, cfg, lr=TRAIN_LR, n_micro=opts.get("n_micro"))
        t0 = time.perf_counter()
        state, loss = step(state, sh.local_batch(plan, tokens))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        # gloo: the step ran its body eagerly, decided before the call
        programs = {"captures": sum(step.programs.captures.values()),
                    "replays": sum(step.programs.replays.values())}
        del step
        launches = launch_counts(_kernels.FLASH)
        staged = dict(sh.HOST_STAGED)
        step_peak = torch.cuda.max_memory_allocated() / 1e9
        n_local = sum(p.numel() for p in tr._leaves(state.params))
        names = tr._leaf_names(state.params)
        specs = tr._leaves(sh.param_specs(plan, cfg))
        grads = [mu.div_(1 - tr.AdamW.B1) for mu in tr._leaves(state.opt_state.mu)]
        del state
        torch.cuda.empty_cache()
        rel, ref_loss = {}, None
        for turn in range(2):
            dist.barrier()
            if turn != rank:
                continue
            t0 = time.perf_counter()
            params = tt.init_params(cfg, 0)
            ref_loss, ref_grads = tr.loss_and_grads(params, tokens, cfg)
            del params
            rel = {n: ((g - r).norm() / r.norm()).item() for n, g, r in zip(
                names, grads, (sh.shard_leaf(r, spec, plan) for r, spec in zip(ref_grads, specs)))}
            del ref_grads
            torch.cuda.empty_cache()
            ref_s = time.perf_counter() - t0
        dist.barrier()
        del grads
        torch.cuda.empty_cache()
        out[name] = {"mesh": plan.axes, "model": model, "layers": layers,
                     "tokens": list(shape), **opts, "local_params": n_local,
                     "loss": loss.item(), "single_process_loss": ref_loss.item(),
                     "grad_norm_rel_err": rel, "init_s": init_s, "step_s": step_s,
                     "single_process_s": ref_s, "launches_per_step": launches,
                     "want_launches": tp2_want(name, axes, layers, rank, opts),
                     "host_staged": staged, "step_peak_mem_gb": step_peak,
                     "programs": programs,
                     "seconds": time.perf_counter() - t_case}
    dist.destroy_process_group()
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def run_cli() -> dict:
    """``python -m tputopo_torch allreduce --topology h100:1``, ``train
    --steps 3 --ckpt-dir D``, ``train --lora-rank 4 --steps 3 --ckpt-dir
    D2`` and ``train --experts 8 --steps 3 --ckpt-dir D3`` as subprocesses
    at the same time, then the trainings for 2 steps more, resumed from
    their checkpoints.  Returns each run's
    exit code, last stdout line and seconds."""
    ckpt = tempfile.mkdtemp(prefix="tputopo_cli_")
    lora_ckpt, moe_ckpt = str(Path(ckpt, "adapter")), str(Path(ckpt, "moe"))
    runs = [{"allreduce": ["allreduce", "--topology", "h100:1"],
             "train": ["train", "--steps", "3", "--ckpt-dir", ckpt],
             "train_lora": ["train", "--lora-rank", "4", "--steps", "3",
                            "--ckpt-dir", lora_ckpt],
             "train_experts": ["train", "--experts", "8", "--steps", "3",
                               "--ckpt-dir", moe_ckpt]},
            {"train_resume": ["train", "--steps", "2", "--ckpt-dir", ckpt],
             "train_lora_resume": ["train", "--lora-rank", "4", "--steps", "2",
                                   "--ckpt-dir", lora_ckpt],
             "train_experts_resume": ["train", "--experts", "8", "--steps", "2",
                                      "--ckpt-dir", moe_ckpt]}]
    out = {}
    try:
        for batch in runs:
            t0 = time.perf_counter()
            procs = {name: subprocess.Popen([sys.executable, "-m", "tputopo_torch", *args],
                                            cwd=REPO, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)
                     for name, args in batch.items()}
            for name, p in procs.items():
                try:
                    stdout, stderr = p.communicate(timeout=300)
                finally:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
                lines = [ln for ln in stdout.splitlines() if ln.strip()]
                out[name] = {"rc": p.returncode, "seconds": time.perf_counter() - t0,
                             "json": json.loads(lines[-1]) if p.returncode == 0 else None,
                             "stderr_tail": stderr[-1500:] if p.returncode else ""}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def start_tp2_ranks() -> dict:
    """Start the two rank processes of ``tp2_gloo_cuda`` (see tp2_rank_main).
    They import, join their gloo group and wait for the ``go`` file, so
    their start-up overlaps the phases before; :func:`phase_tp2_gloo_cuda`
    lets them go once this process has freed the card's memory."""
    workdir = tempfile.mkdtemp(prefix="tputopo_tp2_")
    logs = [open(Path(workdir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--tp2-rank",
                               str(r), workdir], cwd=REPO, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    return {"workdir": workdir, "logs": logs, "procs": procs}


def stop_tp2_ranks(ranks: dict) -> None:
    """Kill rank processes still running, close their logs, remove their
    directory."""
    for p in ranks["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in ranks["logs"]:
        f.close()
    shutil.rmtree(ranks["workdir"], ignore_errors=True)


def phase_tp2_gloo_cuda(ranks: dict) -> dict:
    """Let the two rank processes go (see tp2_rank_main) and hold each case
    against the single-process step: |dloss| <= TRAIN_LOSS_TOL and
    per-leaf ||dgrad|| / ||grad|| <= TRAIN_GRAD_NORM_REL on every rank, and
    each rank's launches against tp2_want.  Gloo stages every collective
    through host memory, so the seconds are no speed figure.  Returns each
    case's launches, by rank."""
    workdir = ranks["workdir"]
    Path(workdir, "go").touch()
    rcs = [p.wait(timeout=900) for p in ranks["procs"]]
    for f in ranks["logs"]:
        f.flush()
    tails = [Path(workdir, f"rank{r}.log").read_text()[-3000:] for r in range(2)]
    check(rcs == [0, 0], f"tp2 rank processes exited {rcs}:\n" + "\n".join(tails))
    results = [json.loads(Path(workdir, f"rank{r}.json").read_text()) for r in range(2)]
    gloo = [r["gloo_cuda"] for r in results]
    emit({"phase": "tp2_gloo_cuda", "check": "gloo all_reduce SUM and MAX on CUDA tensors",
          "ranks": gloo})
    check(all(g["ok"] for g in gloo), f"gloo does not carry all_reduce on CUDA tensors: {gloo}")
    launches = {}
    for name, *_ in TP2_CASES:
        per_rank = [r[name] for r in results]
        dloss = max(abs(r["loss"] - r["single_process_loss"]) for r in per_rank)
        worst = max(max(r["grad_norm_rel_err"].values()) for r in per_rank)
        rec = {"phase": "tp2_gloo_cuda", "case": name, "backend": "gloo, CUDA tensors",
               "ranks": per_rank, "abs_dloss": dloss, "bound_abs_dloss": TRAIN_LOSS_TOL,
               "max_grad_norm_rel_err": worst, "bound_grad_norm_rel": TRAIN_GRAD_NORM_REL,
               "note": "gloo stages every collective through host memory (all_reduce "
                       "inside gloo, the port's point-to-point and all-to-all in "
                       "host_staged): no speed figure"}
        emit(rec)
        check(dloss <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_NORM_REL,
              f"tp2_gloo_cuda {name}: sharded step off the single-process step: {rec}")
        check(all(r["launches_per_step"] == r["want_launches"] for r in per_rank),
              f"tp2_gloo_cuda {name}: launches {[r['launches_per_step'] for r in per_rank]}, "
              f"want {[r['want_launches'] for r in per_rank]}")
        check(all(r["programs"] == {"captures": 0, "replays": 0} for r in per_rank),
              f"tp2_gloo_cuda {name}: a gloo step was graphed: "
              f"{[r['programs'] for r in per_rank]}")
        launches[name] = [r["launches_per_step"] for r in per_rank]
    return launches


def check_cli(cli: dict) -> None:
    emit({"phase": "cli", "runs": cli})
    for name, run in cli.items():
        check(run["rc"] == 0, f"cli {name} exited {run['rc']}: {run['stderr_tail']}")
    ar = cli["allreduce"]["json"]
    check(ar["topology"] == "h100:1" and ar["predicted_gbps"] == 0.0
          and ar["measured_n_devices"] == 1, f"cli allreduce: {ar}")
    for name in ("train", "train_lora", "train_experts"):
        tr1, tr2 = cli[name]["json"], cli[f"{name}_resume"]["json"]
        check(set(tr1) == set(tr2) == CLI_KEYS["train"], f"cli {name}: keys {sorted(tr1)}")
        check(tr1["final_step"] == 3 and tr1["last_loss"] < tr1["first_loss"],
              f"cli {name}: loss did not fall: {tr1}")
        check(tr2["resumed_from"] == 3 and tr2["final_step"] == 5,
              f"cli {name} resume: {tr2}")


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
    from tputopo_torch.distributed import shutdown

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
    decode_entry = timed("decode_attn", phase_decode_attn, att, _kernels.DECODE_ATTN)
    chunk_entry = timed("chunk_attn", phase_chunk_attn, att, _kernels.CHUNK_ATTN)
    timed("repairs", phase_repairs, tt, att, _kernels.FLASH)
    gc.collect()
    torch.cuda.empty_cache()
    params, cfg, tokens, fwd_launches = timed("forward", phase_forward, tt,
                                              _kernels.FLASH)
    prompt, gen_decode_attn, gen_chunk_attn = timed("generate", phase_generate, tt,
                                                    _kernels.FLASH, params, cfg)
    timed("profile_forward", lambda: emit(device_profile(
        "forward", lambda: tt.forward(params, tokens, cfg))))
    timed("profile_generate", lambda: emit(device_profile(
        "generate", lambda: tt.generate(params, prompt, cfg, max_new=GEN_NEW))))
    stream, serve_launches, serve_runs, serve_decode_attn, serve_chunk_attn = timed(
        "serve", phase_serve, tt, _kernels.FLASH, params, cfg)
    prefix, reqs = stream
    serve_profile = timed("profile_serve", profile_serve, tt, params, cfg, prefix, reqs)
    timed("serve_int8", phase_serve_int8, tt, params, cfg, stream)
    timed("serve_int4", phase_serve_int4, tt, params, cfg)
    fwd_jit_launches, fwd_jit_profiled = timed(
        "compiled", phase_compiled, tt, _kernels.FLASH, params, cfg, tokens, prompt,
        stream, serve_runs, serve_profile)
    del serve_runs
    spec_launches = timed("spec_generate", phase_spec_generate, tt, _kernels.FLASH,
                          params, cfg)
    spec_serve_launches, spec_run, spec_reqs = timed("spec_serve", phase_spec_serve, tt,
                                                     _kernels.FLASH, params, cfg)
    timed("compiled_spec", phase_compiled_spec, tt, params, cfg, spec_run, spec_reqs)
    del spec_run
    lora_serve_launches = timed("lora_serve", phase_lora_serve, tt, _kernels.FLASH,
                                params, cfg)
    # The 32-layer parameters (32.1 GB) and the training state (~31 GB)
    # are never resident together.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    timed("resident_weights", phase_resident_weights, tt)
    gc.collect()
    torch.cuda.empty_cache()

    # The parallelism slice on one card: the MoE model at Mixtral-8x7B
    # width, its forward and serving (~24 GB), then its training (~51 GB
    # of state), one at a time.
    moe_params, moe_cfg, moe_fwd_launches = timed("moe_forward", phase_moe_forward, tt,
                                                  _kernels.FLASH)
    timed("moe_grouped", phase_moe_grouped, tt, moe_params, moe_cfg)
    moe_serve_launches = timed("moe_decode_serve", phase_moe_decode_serve, tt,
                               _kernels.FLASH, moe_params, moe_cfg)
    timed("compiled_moe", phase_compiled_moe, tt, moe_params, moe_cfg)
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()
    timed("mla", phase_mla, tt)
    moe_train_launches = timed("moe_train", phase_moe_train, tt, _kernels.FLASH)
    gc.collect()
    torch.cuda.empty_cache()

    state, tcfg, ttokens, step_launches, train_trace, train_ms = timed(
        "train", phase_train, tt, _kernels.FLASH)
    timed("profile_train_step", lambda: emit(device_profile(
        "train_step", lambda: tt.train_step(state, ttokens, tcfg, lr=TRAIN_LR))))
    timed("remat", phase_remat, _kernels.FLASH, state, tcfg, ttokens)
    # One ~31 GB training state at a time: the sharded step builds its own.
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lora_launches, lora_trace, lora_ms = timed("lora_train", phase_lora_train, tt,
                                               _kernels.FLASH)
    gc.collect()
    torch.cuda.empty_cache()

    # The multi-GPU slice.  The rank processes of tp2_gloo_cuda start now
    # and wait until this process holds none of its states; the CLI's runs
    # go beside them.
    t_slice = time.perf_counter()
    tp2 = start_tp2_ranks()
    try:
        timed("dist_world1", phase_dist_world1)
        sharded_launches = timed("sharded_train_world1", phase_sharded_train_world1, tt,
                                 _kernels.FLASH, ttokens, train_trace[0])
        gc.collect()
        torch.cuda.empty_cache()
        compiled_train_launches = timed("compiled_train", phase_compiled_train, tt,
                                        _kernels.FLASH, ttokens, train_trace, train_ms)
        sharded_lora_launches = timed("sharded_lora_world1", phase_sharded_lora_world1, tt,
                                      _kernels.FLASH, lora_trace[0])
        gc.collect()
        torch.cuda.empty_cache()
        compiled_lora_launches = timed("compiled_lora", phase_compiled_lora, tt,
                                       _kernels.FLASH, lora_trace, lora_ms)
        with ThreadPoolExecutor(max_workers=1) as pool:
            cli = pool.submit(timed, "cli", run_cli)
            tp2_launches = timed("tp2_gloo_cuda", phase_tp2_gloo_cuda, tp2)
            cli = cli.result()
        check_cli(cli)
    finally:
        stop_tp2_ranks(tp2)
        shutdown()
    seconds["multi_gpu_slice"] = time.perf_counter() - t_slice
    seconds["multi_gpu_slice_and_repairs"] = seconds["multi_gpu_slice"] + seconds["repairs"]
    # The CLI's single-GPU subcommands in this process: each joins and
    # leaves its own world-1 group, so they run after the slice's group is
    # gone.
    timed("vision", phase_vision, tt)
    timed("compiled_vision", phase_compiled_vision, tt)
    timed("cli_single_gpu", phase_cli_single_gpu)
    seconds["serve_finetune_slice"] = sum(seconds[k] for k in (
        "spec_generate", "spec_serve", "lora_serve", "lora_train", "sharded_lora_world1",
        "vision", "cli_single_gpu"))
    seconds["parallelism_slice_single_process"] = sum(seconds[k] for k in (
        "moe_forward", "moe_decode_serve", "moe_train"))
    seconds["compiled_slice"] = seconds["compiled"] + seconds["compiled_moe"]
    seconds["compiled_train_spec_slice"] = sum(seconds[k] for k in (
        "compiled_spec", "compiled_train", "compiled_lora", "compiled_vision"))
    for e in entries:
        e["launches"] = step_launches[e["name"]]  # per train step, the main path
        e["launches_by_path"] = {"forward": fwd_launches[e["name"]],
                                 # one replay of the captured forward
                                 "forward_jit": fwd_jit_launches[e["name"]],
                                 # the same replay's kernels in a device profile
                                 "forward_jit_profiled": (fwd_jit_profiled
                                                          if e["name"] == "flash_fwd" else 0),
                                 "train_step": step_launches[e["name"]],
                                 # one replay of the jitted (donated) steps
                                 "train_step_jit": compiled_train_launches[e["name"]],
                                 "lora_train_step_jit": compiled_lora_launches[e["name"]],
                                 "serve": serve_launches[e["name"]],
                                 "sharded_train_step": sharded_launches[e["name"]],
                                 "tp2_rank": tp2_launches["tp2"][0][e["name"]],
                                 "lora_train_step": lora_launches[e["name"]],
                                 "sharded_lora_step": sharded_lora_launches[e["name"]],
                                 "spec_generate": spec_launches[e["name"]],
                                 "spec_serve": spec_serve_launches[e["name"]],
                                 "lora_serve": lora_serve_launches[e["name"]],
                                 "moe_forward": moe_fwd_launches[e["name"]],
                                 "moe_serve": moe_serve_launches[e["name"]],
                                 "moe_train": moe_train_launches[e["name"]],
                                 # per rank: the ring's rank r attends r + 1 chunks
                                 "sp2_ring": [r[e["name"]] for r in tp2_launches["sp2_ring"]],
                                 **{k: tp2_launches[k][0][e["name"]]
                                    for k in ("sp2_a2a", "pp2", "ep2")}}
    # one decode step's replay: a launch a layer; one generate call
    decode_entry["launches_by_path"] = {"serve_decode_step_replay": (
        serve_decode_attn["launches"] / serve_decode_attn["decode_steps_replayed"]),
        "generate": gen_decode_attn}
    # one admission's replay: a launch a layer; one generate call's prefill
    chunk_entry["launches_by_path"] = {"serve_admission_replay": (
        serve_chunk_attn["launches"] / serve_chunk_attn["admissions_replayed"]),
        "generate": gen_chunk_attn}
    emit({"phase": "seconds", **seconds})
    emit({"kernels": entries + [decode_entry, chunk_entry]})
    print(name, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp2-rank"]:
        sys.exit(tp2_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
