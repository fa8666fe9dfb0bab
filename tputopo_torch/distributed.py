"""Multi-process bootstrap from the gang's env — the counterpart of
``tputopo/workloads/distributed.py``, on ``torch.distributed``.

The scheduler places a gang (pods sharing ``tpu.dev/gang-id``) on a
contiguous box of hosts, and its processes must rendezvous before any
collective runs.  Every entry point of the port calls
:func:`initialize_from_env` first.

Env contract, the reference's exactly (see
``deploy/examples/job-gang-4x4.yaml``):

- ``TPUTOPO_COORDINATOR`` — ``host:port`` of the rank-0 process (in k8s a
  headless Service name and the job's pod index 0).  A bare host gets
  :data:`DEFAULT_PORT`.  Required when num_processes > 1.
- ``TPUTOPO_NUM_PROCESSES`` (alias ``TPUTOPO_GANG_SIZE``) — gang size;
  1 when unset.
- ``TPUTOPO_PROCESS_ID`` — this process's rank.  When num_processes > 1
  and it is unset, ``JOB_COMPLETION_INDEX`` (k8s Indexed Job), then
  ``TPU_WORKER_ID`` / ``CLOUD_TPU_TASK_ID``.  A single-process job ignores
  the fallbacks: the device plugin injects ``TPU_WORKER_ID`` into every
  container, and a 1-pod job on a non-zero host is still rank 0 of 1.

Two differences from the reference, both deliberate:

- **One process drives one GPU.**  JAX runs one process per host, which
  sees every chip of the host.  PyTorch runs one process per GPU: rank
  ``r`` drives ``cuda:<r % visible devices>`` (:func:`local_device`), so a
  gang of N GPUs is N processes, and the gang size counts GPUs.
- **A single process still gets a group, of size 1.**  JAX needs no
  rendezvous to run collectives over its local devices; ``torch.distributed``
  needs a process group for any collective.  A single-process job builds
  one over an in-memory store, with no coordinator.

The backend follows the device the caller runs on: NCCL for ``cuda``, gloo
for ``cpu``, never whatever happens to be installed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tputopo_torch.model import resolve_device

DEFAULT_PORT = 8476


@dataclass(frozen=True)
class ProcessGroup:
    """The resolved multi-process identity of this workload container."""

    coordinator: str | None
    num_processes: int
    process_id: int

    @property
    def single(self) -> bool:
        return self.num_processes <= 1


def _int_env(env: dict, *names: str) -> int | None:
    for name in names:
        raw = env.get(name, "").strip()
        if raw:
            try:
                return int(raw)
            except ValueError:
                raise ValueError(f"{name} must be an integer, got {raw!r}")
    return None


def process_group_from_env(env: dict | None = None) -> ProcessGroup:
    """Resolve (coordinator, num_processes, process_id) per the module
    contract; raises on inconsistent configuration instead of letting a
    half-configured gang hang in rendezvous."""
    env = dict(os.environ if env is None else env)
    num = _int_env(env, "TPUTOPO_NUM_PROCESSES", "TPUTOPO_GANG_SIZE")
    if num is None:
        num = 1
    if num > 1:
        pid = _int_env(env, "TPUTOPO_PROCESS_ID", "JOB_COMPLETION_INDEX",
                       "TPU_WORKER_ID", "CLOUD_TPU_TASK_ID")
    else:
        # Only the explicit variable counts for single-process jobs: the
        # device plugin injects TPU_WORKER_ID (its host ordinal) into
        # every container, and a 1-pod job on worker 1 is still rank 0.
        pid = _int_env(env, "TPUTOPO_PROCESS_ID")
    if pid is None:
        pid = 0
    coord = env.get("TPUTOPO_COORDINATOR", "").strip() or None
    if coord is not None and ":" not in coord:
        coord = f"{coord}:{DEFAULT_PORT}"
    if num < 1:
        raise ValueError(f"num_processes must be >= 1, got {num}")
    if not 0 <= pid < num:
        raise ValueError(
            f"process_id {pid} out of range for {num} processes (ranks "
            "must be dense 0..n-1 — is JOB_COMPLETION_INDEX wired?)")
    if num > 1 and coord is None:
        raise ValueError(
            "TPUTOPO_NUM_PROCESSES > 1 needs TPUTOPO_COORDINATOR "
            "(rank-0 'host:port'; in k8s a headless Service name, see "
            "deploy/examples/job-gang-4x4.yaml)")
    return ProcessGroup(coordinator=coord, num_processes=num, process_id=pid)


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(rank: int, device=None) -> torch.device:
    """The device rank ``rank`` drives: ``cuda:<rank % visible devices>``
    on the GPU (one process per GPU), the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_from_env(env: dict | None = None, *, device=None,
                        **kwargs) -> ProcessGroup:
    """Join the gang's process group (a group of one for a single process)
    and bind this process to its device.  Returns the resolved identity.

    ``device`` is ``cuda`` unless the caller asks for ``"cpu"``; it picks
    the backend.  A process that already belongs to a group keeps it.
    Extra kwargs pass through to ``torch.distributed.init_process_group``
    (e.g. ``timeout`` for a fail-loud rendezvous bound)."""
    group = process_group_from_env(env)
    dev = local_device(group.process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return group
    backend = backend_for(dev)
    if group.single:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{group.coordinator}",
            rank=group.process_id, world_size=group.num_processes, **kwargs)
    return group


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
