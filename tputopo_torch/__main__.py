"""``python -m tputopo_torch`` — the in-container acceptance workload, the
counterpart of ``python -m tputopo.workloads``.

- ``allreduce``: measure the all-reduce over the gang's GPUs and compare
  with the link model's prediction for the slice topology (``--topology
  h100:<n>``, or the injected ``TPU_SLICE_TOPOLOGY`` env).  Exit code 1
  when efficiency falls below ``--min-efficiency``.
- ``train``: run N sharded training steps of the flagship LM over the
  gang (mesh planned from the world size), with checkpoint/resume, a
  token corpus, graceful SIGTERM preemption and a profiler trace;
  ``--lora-rank`` trains LoRA adapters over a frozen base instead.
- ``decode``: greedy KV-cache decode throughput (``--int8``/``--int4``).
- ``serve``: the continuous-batching engine over a seeded request stream,
  with prefixes, chunked prefill, streaming, quantized weights, or
  speculative decoding (``--spec-draft-layers``).
- ``train-vision``: the conv classifier, data parallel over the gang.

Every process of a gang runs this with the gang's env
(:mod:`tputopo_torch.distributed`): one process per GPU.  ``decode`` and
``serve`` run on that one process's device (a gang's processes serve as
replicas; the ``mesh`` key is the plan of one device).  ``--device cpu``
runs on the CPU over gloo (the counterpart of ``JAX_PLATFORMS=cpu``).
The flags, defaults, JSON keys and exit codes are the reference's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys

def cmd_allreduce(args) -> int:
    from tputopo_torch.validate import validate_slice

    spec = args.topology or os.environ.get("TPU_SLICE_TOPOLOGY")
    gen = os.environ.get("TPU_ACCELERATOR_TYPE", "")
    if spec and ":" not in spec and gen:
        # Allocate-injected env carries bare dims; prepend the generation
        # from the accelerator type ("h100-8" -> "h100").
        spec = f"{gen.split('-')[0]}:{spec}"
    if not spec:
        print("error: no --topology and no TPU_SLICE_TOPOLOGY env",
              file=sys.stderr)
        return 2
    try:
        report = validate_slice(spec, payload_mb=args.payload_mb, iters=args.iters)
    except ValueError as e:  # a topology spec the link model cannot take
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report.to_dict()))
    if args.min_efficiency and report.efficiency < args.min_efficiency:
        print(f"FAIL: efficiency {report.efficiency:.3f} < "
              f"{args.min_efficiency}", file=sys.stderr)
        return 1
    return 0


def cmd_train(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from tputopo_torch import checkpoint as ckptlib
    from tputopo_torch.model import ModelConfig
    from tputopo_torch.sharding import local_batch, mesh_for_slice
    from tputopo_torch.train import (make_sharded_params, make_sharded_state,
                                     make_sharded_train_step)

    n = dist.get_world_size()
    moe = None
    if args.experts:
        from tputopo_torch.moe import MoEConfig

        moe = MoEConfig(n_experts=args.experts)
    elif args.ep > 1:
        print("error: --ep needs --experts (a dense model would replicate "
              "over the ep axis and waste those chips)", file=sys.stderr)
        return 2
    config = ModelConfig(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
                         n_kv_heads=4, d_ff=512, max_seq=args.seq, moe=moe,
                         sp_impl=args.sp_impl)
    accum = max(1, args.accum)
    specs = None  # the checkpoint's layout: the model's unless LoRA
    try:
        plan = mesh_for_slice((n,), device=args.device, heads=config.n_heads,
                              pp=args.pp, ep=args.ep, sp=args.sp, tp=args.tp)
        if config.n_layers % plan.size("pp"):
            print(f"error: --pp {args.pp} must divide {config.n_layers} layers",
                  file=sys.stderr)
            return 2
        if args.lora_rank:
            # Parameter-efficient finetuning: the base tree is frozen (a
            # fresh init standing in for restored pretrained weights; point
            # --ckpt-dir at an adapter dir to resume the ADAPTER), only the
            # LoRA TrainState trains and checkpoints.
            from tputopo_torch import lora

            base = make_sharded_params(plan, config, 0)
            state = lora.make_sharded_lora_state(plan, config, 1, rank=args.lora_rank)
            specs = lora.lora_shardings(plan, state.params, config)
            lora_step = lora.make_sharded_lora_train_step(plan, config, state.params,
                                                          accum_steps=accum)

            def step(s, t):
                return lora_step(s, base, t)
        else:
            state = make_sharded_state(plan, config, 0)  # raises on a tp that cannot split
            step = make_sharded_train_step(plan, config, accum_steps=accum)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    resumed_from = None
    if args.ckpt_dir:
        restored = ckptlib.restore(args.ckpt_dir, state, plan=plan, config=config,
                                   specs=specs)
        if restored is not None:
            state = restored
            resumed_from = int(state.step)
    dp = plan.size("dp")
    # Batch must shard over dp, split into pp microbatches, AND divide into
    # gradient-accumulation microbatches.
    q = dp * plan.size("pp") * accum
    batch = max(q, args.batch // q * q)
    batch_for = None
    if args.data:
        # Real corpus: deterministic disjoint shards per (step, dp rank),
        # resumable from the checkpointed step.  One process drives one
        # GPU, so the data ranks are the dp coordinates: the ranks of one
        # tp (or ep, pp) group read the same rows, and an sp rank keeps its
        # chunk of the sequence.
        from tputopo_torch.data import TokenDataset

        ds = TokenDataset(args.data, dtype=args.data_dtype)
        hi = ds.max_token()
        if hi >= config.vocab_size:
            print(f"error: corpus has token id {hi} >= vocab "
                  f"{config.vocab_size}", file=sys.stderr)
            return 2
        dp_rank = plan.rank("dp")

        def batch_for(i: int) -> torch.Tensor:
            local = ds.batch(i, batch // dp, args.seq, rank=dp_rank, world=dp)
            chunk = torch.from_numpy(local).chunk(plan.size("sp"), dim=1)[plan.rank("sp")]
            return chunk.contiguous().to(plan.device)

    # Fixed synthetic batch otherwise: the convergence check is
    # memorization, which must always reduce loss.
    rng = np.random.default_rng(0)
    tokens = local_batch(plan, torch.from_numpy(
        rng.integers(0, config.vocab_size, (batch, args.seq))).to(plan.device))

    # Graceful preemption: kubernetes sends SIGTERM (then SIGKILL after the
    # grace period) when it evicts the pod.  Finish the in-flight step,
    # save, and exit cleanly so the replacement pod resumes.  The flag
    # flips between steps; nothing async-unsafe happens in the handler.
    preempted = {"flag": False}

    def _on_preempt(signum, frame):
        preempted["flag"] = True

    try:
        prev_term = signal.signal(signal.SIGTERM, _on_preempt)
    except ValueError:  # non-main thread (tests driving main() directly)
        prev_term = None

    def sync_preempt(local: bool) -> bool:
        # The gang must agree on the stop step: kubelet signals each pod on
        # its own, and a rank that stops a step early leaves its peers
        # blocked in a collective.  One all-reduce of max per step.
        flag = torch.tensor([int(local)], dtype=torch.int32, device=plan.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    if args.profile and args.steps < 2:
        print("warning: --profile needs --steps >= 2 (step 0 is the warm-up "
              "step and is excluded); no trace will be written", file=sys.stderr)
    losses = []
    last_saved = None
    prof = None
    try:
        for i in range(args.steps):
            if batch_for is not None:
                tokens = batch_for(i + (resumed_from or 0))
            state, loss = step(state, tokens)
            losses.append(float(loss))
            if args.profile and i == 0 and args.steps > 1:
                prof = _start_profile(plan.device)
            if args.ckpt_dir and args.save_every and (i + 1) % args.save_every == 0:
                last_saved = ckptlib.save(args.ckpt_dir, state, plan=plan,
                                          config=config, specs=specs)
            stop = preempted["flag"]
            if n > 1:
                stop = sync_preempt(stop)
            if stop:
                preempted["flag"] = True
                break
        if prof is not None:
            _stop_profile(prof, args.profile, dist.get_rank())
            prof = None
        # Final save inside the handler's scope: a second SIGTERM during
        # the save must not kill the write that preserves the run.
        if args.ckpt_dir and last_saved != int(state.step):
            ckptlib.save(args.ckpt_dir, state, plan=plan, config=config, specs=specs)
    finally:
        if prof is not None:  # crash mid-trace: stop the profiler
            prof.stop()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    print(json.dumps({
        "devices": n, "mesh": plan.axes, "steps": args.steps,
        "resumed_from": resumed_from, "final_step": int(state.step),
        "preempted": preempted["flag"],
        "first_loss": round(losses[0], 4), "last_loss": round(losses[-1], 4),
    }))
    if preempted["flag"]:
        # With a checkpoint saved, exit 0 so the Job controller counts the
        # pod done; without --ckpt-dir nothing was preserved, so exit
        # nonzero and let the work be retried.
        return 0 if args.ckpt_dir else 1
    if batch_for is not None:
        # Fresh corpus batches each step need not reduce loss monotonically.
        return 0 if all(math.isfinite(l) for l in losses) else 1
    return 0 if losses[-1] < losses[0] or resumed_from else 1


def _maybe_quantize(params: dict, int8: bool, int4: bool = False) -> dict:
    """Weight-only quantization for the serving CLIs, on the device that
    holds the params.  --int4 stacks on the int8 KV cache: weights stream
    grouped int4 (half of int8's bytes again), the cache stays int8."""
    if not (int8 or int4):
        return params
    from tputopo_torch.quant import quantize_params

    return quantize_params(params, bits=4 if int4 else 8)


def _lm_config(args):
    """The serving CLIs' model: the reference's, sized to the request."""
    from tputopo_torch.model import ModelConfig

    return ModelConfig(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
                       n_kv_heads=4, d_ff=512, max_seq=args.prompt_len + args.max_new,
                       kv_dtype="int8" if args.int8 or args.int4 else "bf16")


def _one_device_mesh(heads: int) -> dict:
    """The ``mesh`` key of a subcommand that runs on this process's one
    device: the plan of one device."""
    from tputopo_torch.sharding import plan_mesh

    return plan_mesh(1, heads=heads)


def cmd_decode(args) -> int:
    import time

    import numpy as np
    import torch

    from tputopo_torch.decode import generate_jit
    from tputopo_torch.model import init_params

    cfg = _lm_config(args)
    batch = max(1, args.batch)
    params = _maybe_quantize(init_params(cfg, 0, device=args.device), args.int8,
                             args.int4)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, args.prompt_len))).to(args.device)
    # The reference times generate_jit after a compile call: the first
    # call captures the program, the timed one replays it.
    generate_jit(params, prompt, cfg, max_new=args.max_new)
    _sync(args.device)
    t0 = time.perf_counter()
    generate_jit(params, prompt, cfg, max_new=args.max_new)
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "batch": batch, "prompt_len": args.prompt_len,
        "max_new": args.max_new, "mesh": _one_device_mesh(cfg.n_kv_heads),
        "decode_tokens_per_s": round(batch * args.max_new / dt, 1),
        "wall_s": round(dt, 4),
    }))
    return 0


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def cmd_serve(args) -> int:
    """Continuous-batching serving demo: mixed-length prompts stream
    through a slotted engine (ragged prefill, EOS off, slot reuse)."""
    import time

    import numpy as np

    from tputopo_torch.model import init_params
    from tputopo_torch.serving import ServingEngine

    cfg = _lm_config(args)
    # Flag validation BEFORE any device work (init, quantization).
    if args.spec_draft_layers:
        if not 0 < args.spec_draft_layers < cfg.n_layers:
            print(f"error: --spec-draft-layers must be in "
                  f"(0, {cfg.n_layers})", file=sys.stderr)
            return 2
        if args.spec_gamma < 1:
            print("error: --spec-gamma must be >= 1", file=sys.stderr)
            return 2
        incompatible = [f for f, v in (("--prefix-len", args.prefix_len),
                                       ("--prefill-chunk", args.prefill_chunk))
                        if v]
        if args.steps_per_tick != 8:  # non-default: would be silently ignored
            incompatible.append("--steps-per-tick")
        if incompatible:
            print(f"error: --spec-draft-layers is incompatible with "
                  f"{', '.join(incompatible)} (a speculative tick is one "
                  "verify stream; draft-cache mirroring for prefix/chunked "
                  "admission is future work)", file=sys.stderr)
            return 2
    mesh = _one_device_mesh(cfg.n_kv_heads)
    params = _maybe_quantize(init_params(cfg, 0, device=args.device), args.int8,
                             args.int4)
    rng = np.random.default_rng(0)
    lens = rng.integers(max(1, args.prompt_len // 4), args.prompt_len + 1,
                        args.requests)
    max_len = args.prefix_len + args.prompt_len + args.max_new
    on_tokens = None
    if args.stream:
        # JSONL stream ahead of the final summary line: one record per
        # engine tick per request with its newly committed tokens.
        def on_tokens(rid, toks):
            print(json.dumps({"rid": rid, "tokens": toks}), flush=True)
    if args.spec_draft_layers:
        from tputopo_torch.speculative import SpecServingEngine

        eng = SpecServingEngine(params, cfg, slots=args.slots, max_len=max_len,
                                prompt_pad=args.prompt_len,
                                draft_layers=args.spec_draft_layers,
                                gamma=args.spec_gamma, on_tokens=on_tokens)
    else:
        eng = ServingEngine(params, cfg, slots=args.slots, max_len=max_len,
                            prompt_pad=args.prompt_len,
                            steps_per_tick=args.steps_per_tick,
                            prefill_chunk=args.prefill_chunk, on_tokens=on_tokens)
    pid = None
    if args.prefix_len:
        # Shared system-prompt demo: its KV computes once, every request
        # below reuses it by copy.
        pid = eng.register_prefix(
            rng.integers(0, cfg.vocab_size, (args.prefix_len,)).tolist())
    ids = [eng.submit(rng.integers(0, cfg.vocab_size, (L,)).tolist(),
                      max_new=args.max_new, prefix=pid) for L in lens]
    t0 = time.perf_counter()
    results = eng.run()
    _sync(args.device)
    dt = time.perf_counter() - t0
    base = args.prefix_len + np.asarray(lens)
    generated = sum(len(results[i]) - int(b) for i, b in zip(ids, base))
    out = {
        "requests": args.requests, "slots": args.slots, "mesh": mesh,
        "prompt_lens": f"{lens.min()}..{lens.max()}",
        "prefix_len": args.prefix_len,
        "generated_tokens": int(generated),
        "decode_steps": eng.metrics["decode_steps"],
        "prefix_admits": eng.metrics["prefix_admits"],
        "tokens_per_s": round(generated / dt, 1),
        "wall_s": round(dt, 3),
    }
    if args.stream:
        # The timed window includes the stream's host I/O: mark the record
        # so throughput is not compared across flag sets.
        out["stream"] = True
    if args.spec_draft_layers:
        out["drafted_accepted"] = eng.metrics["drafted_accepted"]
    print(json.dumps(out))
    return 0 if len(results) == args.requests else 1


def cmd_train_vision(args) -> int:
    import torch.distributed as dist

    from tputopo_torch.sharding import mesh_for_slice
    from tputopo_torch.vision import VisionConfig, train_vision

    n = dist.get_world_size()
    plan = mesh_for_slice((n,), device=args.device, tp=1)  # pure data parallel
    dp = plan.size("dp")
    batch = max(dp, args.batch // dp * dp)
    losses = train_vision(plan, VisionConfig(), steps=args.steps, batch=batch)
    print(json.dumps({
        "devices": n, "mesh": plan.axes, "steps": args.steps,
        "first_loss": round(losses[0], 4), "last_loss": round(losses[-1], 4),
    }))
    return 0 if losses[-1] < losses[0] else 1


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, out_dir: str, rank: int) -> None:
    """Stop ``prof`` and write its Chrome trace (``chrome://tracing``,
    Perfetto) into ``out_dir``, one file per rank."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_rank{rank}.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tputopo-torch-workload")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="run on this process's GPU (NCCL) or on the CPU "
                            "(gloo)")

    p = sub.add_parser("allreduce", help="measure vs predicted all-reduce")
    p.add_argument("--topology", help="slice spec, e.g. h100:8 "
                                      "(default: injected env)")
    p.add_argument("--payload-mb", type=float, default=16.0)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--min-efficiency", type=float, default=0.0)
    device_flag(p)
    p.set_defaults(fn=cmd_allreduce)

    p = sub.add_parser("train", help="sharded LM training steps")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree (default: policy)")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel degree (context parallelism)")
    p.add_argument("--sp-impl", choices=("ring", "a2a"), default="ring",
                   help="context-parallel strategy (acts only with --sp > 1)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (GPipe over the layer stack)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (requires --experts)")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE experts per layer (0 = dense FFN)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir: resume if present, save at end "
                        "(and every --save-every steps)")
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step")
    p.add_argument("--data", default=None, metavar="TOKENS.bin",
                   help="train on a flat binary token-id corpus (np.memmap'd; "
                        "deterministic disjoint shards per step and dp rank, "
                        "resumable) instead of the fixed synthetic batch")
    p.add_argument("--data-dtype", default="uint16",
                   help="stored token dtype of --data (uint16 default)")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="train only LoRA adapters of this rank on the "
                        "attention q/v projections (base frozen; adapter "
                        "checkpoints via --ckpt-dir)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the steps "
                        "after step 0 into DIR (--steps must be >= 2)")
    device_flag(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("decode", help="KV-cache greedy decode throughput")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--max-new", type=int, default=64)
    p.add_argument("--int8", action="store_true",
                   help="full int8 serving stack: weight-only int8 + int8 "
                        "KV cache (decode streams bytes; bytes are the lever)")
    p.add_argument("--int4", action="store_true",
                   help="grouped int4 weights (half of int8's stream "
                        "again) over the int8 KV cache")
    device_flag(p)
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("serve", help="continuous-batching serving engine "
                                     "(ragged prompts, slot reuse)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64,
                   help="prefill bucket; prompts sample 1/4..1x of it")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--steps-per-tick", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="chunked prefill: long prompts prefill this many "
                        "tokens per tick, interleaved with decode (bounds "
                        "head-of-line blocking); must divide --prompt-len")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="shared system-prompt length: its KV computes once "
                        "(register_prefix) and every request reuses it")
    p.add_argument("--stream", action="store_true",
                   help="emit a JSONL token stream ({rid, tokens} per "
                        "engine tick) ahead of the final summary line; "
                        "the summary's tokens_per_s then includes the "
                        "stream's host I/O (it carries stream:true so "
                        "numbers are not compared across flag sets)")
    p.add_argument("--int8", action="store_true",
                   help="full int8 serving stack: weights + KV cache")
    p.add_argument("--int4", action="store_true",
                   help="grouped int4 weights (half of int8's stream "
                        "again) over the int8 KV cache")
    p.add_argument("--spec-draft-layers", type=int, default=0,
                   help="speculative continuous batching: draft with this "
                        "many leading layers, verify per tick (greedy; "
                        "lossless at f32 — at bf16/int8 a near-tie argmax "
                        "can flip within a ulp between the width-1 and "
                        "width-gamma+1 blocks; reports drafted_accepted)")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens per speculative tick")
    device_flag(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train-vision",
                       help="conv classifier, data parallel (Gaia Exp.6 analog)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=64)
    device_flag(p)
    p.set_defaults(fn=cmd_train_vision)

    args = ap.parse_args(argv)
    from tputopo_torch.distributed import initialize_from_env, shutdown

    # The gang rendezvous before anything touches a collective (a group of
    # one for a single process).
    try:
        group = initialize_from_env(device=args.device)
    except (ValueError, RuntimeError) as e:  # bad env; no GPU without --device cpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not group.single:
        print(f"torch.distributed: rank {group.process_id}/"
              f"{group.num_processes} via {group.coordinator}",
              file=sys.stderr)
    try:
        return args.fn(args)
    finally:
        shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
