"""All-reduce microbenchmark, the acceptance workload — the counterpart of
``tputopo/workloads/collective.py``, on ``torch.distributed``.

It measures the north-star metric directly: all-reduce GB/s over the
devices of the scheduled slice, to hold against the link model's
prediction (:mod:`tputopo_torch.linkmodel`, :mod:`tputopo_torch.validate`).

Conventions match NCCL-tests, as in the reference:
  algbw = per-rank buffer bytes / time   (what the user's gradient feels)
  busbw = algbw * 2 * (n - 1) / n        (per-link wire pressure)

The payload is the reference's global array: ``elems`` elements (rounded
to a multiple of the rank count), of which each rank holds its own
``elems // n``.  One step is ``dist.all_reduce`` of that buffer.  On CUDA
each step is timed by a pair of CUDA events after a barrier, on the CPU by
the host clock; the result is the median.  The measurement checks the
reduced buffer against its exact sum and raises if they differ: a
bandwidth of a wrong collective is not reported.

On one GPU the group has one rank and the all-reduce moves nothing over a
link: the time is that of the collective's call, not of any link.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AllReduceResult:
    n_devices: int
    payload_mb: float       # global (sharded) array size, as requested
    time_ms: float          # median of timed iterations
    algbw_gbps: float       # per-rank buffer bytes / time (NCCL-tests algbw)
    busbw_gbps: float

    def to_dict(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "payload_mb": round(self.payload_mb, 3),
            "time_ms": round(self.time_ms, 4),
            "algbw_gbps": round(self.algbw_gbps, 3),
            "busbw_gbps": round(self.busbw_gbps, 3),
        }


def _device() -> torch.device:
    """The device of the process group's backend: this process's GPU under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _timed_allreduce(buf: torch.Tensor, src: torch.Tensor, group, iters: int,
                     warmup: int) -> float:
    """Median seconds of ``all_reduce(buf)`` over ``iters`` runs, each on a
    fresh copy of ``src`` made before the barrier that starts it."""
    cuda = buf.device.type == "cuda"
    times = []
    for i in range(warmup + iters):
        buf.copy_(src)
        dist.barrier(group=group)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(buf, group=group)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=group)
            t = time.perf_counter() - t0
        if i >= warmup:
            times.append(t)
    return statistics.median(times)


def _shard(slot: int, per: int, dtype, device) -> torch.Tensor:
    """Block ``slot`` of the global array ``arange(elems)`` in ``dtype``."""
    return torch.arange(slot * per, (slot + 1) * per, device=device).to(dtype)


def _check_sum(buf: torch.Tensor, slots: list[int], per: int) -> None:
    """``buf`` must be the sum of the blocks ``slots`` held, within the
    rounding of one add per block at ``buf``'s precision."""
    want = sum(_shard(s, per, buf.dtype, buf.device).double() for s in slots)
    rtol = torch.finfo(buf.dtype).eps * len(slots)
    if not torch.allclose(buf.double(), want, rtol=rtol, atol=0.0):
        err = (buf.double() - want).abs().max().item()
        raise RuntimeError(f"all-reduce returned a wrong sum (max abs error {err})")


def _result(n: int, total: int, itemsize: int, per: int, t: float) -> AllReduceResult:
    # NCCL-tests convention: algbw = per-rank buffer bytes / time.
    algbw = per * itemsize / t / 1e9
    return AllReduceResult(
        n_devices=n, payload_mb=total * itemsize / 1e6, time_ms=t * 1e3,
        algbw_gbps=algbw,
        busbw_gbps=algbw * 2.0 * (n - 1) / n if n > 1 else algbw)


def measure_allreduce(group=None, payload_mb: float = 8.0, iters: int = 20,
                      warmup: int = 3, dtype=torch.float32) -> AllReduceResult:
    """Time an all-reduce over ``group`` (default: the whole world)."""
    n = dist.get_world_size(group)
    slot = dist.get_rank(group)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    elems = max(n, int(payload_mb * 1e6) // itemsize // n * n)
    per = elems // n
    src = _shard(slot, per, dtype, _device())
    buf = torch.empty_like(src)
    t = _timed_allreduce(buf, src, group, iters, warmup)
    _check_sum(buf, list(range(n)), per)
    return _result(n, elems, itemsize, per, t)


def measure_axis_allreduce(plan, axis: str, payload_mb: float = 8.0,
                           iters: int = 10, warmup: int = 2,
                           dtype=torch.float32) -> AllReduceResult:
    """All-reduce over ONE logical axis of a MeshPlan (e.g. the dp gradient
    ring), the other axes independent replicas — what a DP x TP training
    step does each step.  Each rank holds the ``rank``-th block of the
    global array."""
    n = plan.size(axis)
    group = plan.group(axis)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    total = max(plan.n_devices, int(payload_mb * 1e6) // itemsize)
    total = total // plan.n_devices * plan.n_devices
    per = total // plan.n_devices
    src = _shard(dist.get_rank(), per, dtype, plan.device)
    buf = torch.empty_like(src)
    t = _timed_allreduce(buf, src, group, iters, warmup)
    _check_sum(buf, dist.get_process_group_ranks(group), per)
    return _result(n, total, itemsize, per, t)
