"""``python -m tputopo_torch`` — the in-container acceptance workload, the
counterpart of ``python -m tputopo.workloads`` (its ``allreduce`` and
``train`` subcommands; ``decode``, ``serve`` and ``train-vision`` come with
a later slice of the port).

- ``allreduce``: measure the all-reduce over the gang's GPUs and compare
  with the link model's prediction for the slice topology (``--topology
  h100:<n>``, or the injected ``TPU_SLICE_TOPOLOGY`` env).  Exit code 1
  when efficiency falls below ``--min-efficiency``.
- ``train``: run N sharded training steps of the flagship LM over the
  gang (mesh planned from the world size), with checkpoint/resume, a
  token corpus, graceful SIGTERM preemption and a profiler trace.

Every process of a gang runs this with the gang's env
(:mod:`tputopo_torch.distributed`): one process per GPU.  ``--device cpu``
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

#: Flags of the reference's ``train`` the port does not run yet, with the
#: later slice each comes with: (attribute, is it set?, slice).
_UNPORTED = (
    ("--experts", lambda a: bool(a.experts), "the MoE slice (moe.py)"),
    ("--ep", lambda a: a.ep > 1, "the MoE slice (moe.py)"),
    ("--pp", lambda a: a.pp > 1, "the GPipe slice (pipeline.py)"),
    ("--sp", lambda a: (a.sp or 1) > 1, "the ring/Ulysses context-parallel slice"),
    ("--lora-rank", lambda a: bool(a.lora_rank), "the LoRA slice (lora.py)"),
)


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
    from tputopo_torch.train import make_sharded_state, make_sharded_train_step

    for flag, is_set, later in _UNPORTED:
        if is_set(args):
            print(f"error: {flag} is not ported yet: it comes with {later} of "
                  "tputopo_torch", file=sys.stderr)
            return 2
    n = dist.get_world_size()
    config = ModelConfig(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
                         n_kv_heads=4, d_ff=512, max_seq=args.seq,
                         sp_impl=args.sp_impl)
    try:
        plan = mesh_for_slice((n,), device=args.device, heads=config.n_heads,
                              tp=args.tp)
        state = make_sharded_state(plan, config, 0)  # raises on a tp that cannot split
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    resumed_from = None
    if args.ckpt_dir:
        restored = ckptlib.restore(args.ckpt_dir, state, plan=plan, config=config)
        if restored is not None:
            state = restored
            resumed_from = int(state.step)
    accum = max(1, args.accum)
    step = make_sharded_train_step(plan, config, accum_steps=accum)
    dp = plan.size("dp")
    # Batch must shard over dp AND divide into accumulation microbatches.
    q = dp * accum
    batch = max(q, args.batch // q * q)
    batch_for = None
    if args.data:
        # Real corpus: deterministic disjoint shards per (step, dp rank),
        # resumable from the checkpointed step.  One process drives one
        # GPU, so the data ranks are the dp coordinates: the ranks of one
        # tp group read the same rows.
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
            return torch.from_numpy(local).to(plan.device)

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
                                          config=config)
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
            ckptlib.save(args.ckpt_dir, state, plan=plan, config=config)
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
                   help="sequence-parallel degree (not ported yet above 1)")
    p.add_argument("--sp-impl", choices=("ring", "a2a"), default="ring",
                   help="context-parallel strategy (acts only with --sp > 1)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages (not ported yet above 1)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (not ported yet above 1)")
    p.add_argument("--experts", type=int, default=0,
                   help="MoE experts per layer (not ported yet)")
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
                   help="LoRA adapters of this rank (not ported yet)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the steps "
                        "after step 0 into DIR (--steps must be >= 2)")
    device_flag(p)
    p.set_defaults(fn=cmd_train)

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
