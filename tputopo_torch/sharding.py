"""Scheduled slice → named device mesh — the counterpart of
``tputopo/workloads/sharding.py``, over ``torch.distributed``.

The extender allocates a contiguous slice so that a mesh laid over its
devices runs its collectives on the fastest links.  Here a
:class:`MeshPlan` is a ``DeviceMesh`` over the ranks of the process group,
row-major in :data:`AXES` order, with one process group per logical axis.
One process drives one device (:mod:`tputopo_torch.distributed`), so a
rank is a device and ``tp`` innermost puts tensor-parallel peers on
neighbouring ranks.

Where the reference lays out parameters by ``NamedSharding`` and lets XLA
insert the collectives, the port keeps each rank's local shard of every
leaf and writes the collectives out in the model code
(:mod:`tputopo_torch.model`).  :func:`param_specs` says, per leaf and per
dimension, which mesh axis splits it; :func:`shard_tree` cuts a full tree
into this rank's shards and :func:`gather_tree` puts it back together.
:func:`constrain` stays the identity: a layout in the port is carried by
those explicit collectives, not by annotations.

Every axis runs: ``dp`` and ``tp`` in the model and the step, ``ep`` in
:mod:`tputopo_torch.moe`, ``sp`` in :mod:`tputopo_torch.ring` and
:mod:`tputopo_torch.ulysses`, ``pp`` in :mod:`tputopo_torch.pipeline`.  The
point-to-point and all-to-all traffic of those goes through the helpers at
the end of this module (:func:`exchange`, :func:`all_to_all`,
:func:`all_gather`, :func:`broadcast`), which NCCL carries directly.  Gloo
carries ``all_reduce`` on CUDA tensors but not those, so under gloo the
helpers stage a CUDA tensor through host memory, explicitly: a CPU copy
goes over the wire and the result is copied back (:data:`HOST_STAGED`
counts these calls).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Logical mesh axes, outermost to innermost, in the reference's order: tp
# (per-token collectives, the chattiest) innermost, pp outermost.
AXES = ("pp", "dp", "sp", "ep", "tp")


@dataclass
class MeshPlan:
    """A device mesh over the process group's ranks plus the logical-axis
    sizes laid over it."""

    mesh: DeviceMesh
    axes: dict[str, int] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh.mesh.shape)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's peers along ``axis``."""
        return self.mesh.get_group(axis)

    def groups(self) -> list:
        """The process groups of every axis: what decides whether a step's
        compiled program replays (:func:`~._graphs.replays`)."""
        return self.mesh.get_all_groups()

    def spec(self, *names: str | None) -> tuple:
        """Axis names per dimension, axes of size 1 dropped to None (the
        reference's ``PartitionSpec``, read as a tuple)."""
        return tuple(n if n is not None and self.size(n) > 1 else None
                     for n in names)

    def replicated(self) -> tuple:
        return ()

    def peer(self, axis: str, coord: int) -> int:
        """The global rank of the peer at ``coord`` along ``axis`` (this
        rank's coordinates on the other axes)."""
        return dist.get_global_rank(self.group(axis), coord % self.size(axis))


_ACTIVE: MeshPlan | None = None


@contextmanager
def activate(plan: MeshPlan):
    """Make ``plan`` the active plan within the block: the model then runs
    its tensor-, expert-, context- and pipeline-parallel paths over the
    plan's groups."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def active_plan() -> MeshPlan | None:
    return _ACTIVE


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """The identity: the port carries layout by explicit collectives."""
    return x


def plan_mesh(n_devices: int, *, tp: int | None = None, sp: int | None = None,
              pp: int = 1, ep: int = 1,
              heads: int | None = None) -> dict[str, int]:
    """Choose axis sizes for ``n_devices``, with the reference's policy:
    tensor parallelism up to 4, bounded by the head count it must divide;
    the rest goes to dp; sp, pp and ep only on explicit request."""
    if n_devices % (pp * ep):
        raise ValueError(f"pp={pp} x ep={ep} does not divide "
                         f"{n_devices} devices")
    if tp is None:
        tp = 1
        for cand in (4, 2):
            if (n_devices // (pp * ep)) % cand == 0 and \
                    (heads is None or heads % cand == 0):
                tp = cand
                break
    if n_devices % (pp * ep * tp):
        raise ValueError(f"pp={pp} x ep={ep} x tp={tp} does not divide "
                         f"{n_devices} devices")
    rest = n_devices // (pp * ep * tp)
    if sp is None:
        sp = 1
    if rest % sp:
        raise ValueError(f"sp={sp} does not divide {rest} remaining devices")
    return {"pp": pp, "dp": rest // sp, "sp": sp, "ep": ep, "tp": tp}


def build_mesh(axes: dict[str, int], device=None) -> MeshPlan:
    """The plan for logical ``axes`` over the current process group: ranks
    laid out row-major in :data:`AXES` order, as the reference reshapes
    its devices.  ``device`` is the device type of the mesh (this rank's
    device, cuda unless asked for the CPU)."""
    from tputopo_torch.model import resolve_device

    shape = tuple(axes.get(a, 1) for a in AXES)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"axes {axes} need {math.prod(shape)} devices, "
                         f"got {world}")
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(world).reshape(shape), mesh_dim_names=AXES)
    return MeshPlan(mesh=mesh, axes={a: axes.get(a, 1) for a in AXES})


def mesh_for_slice(slice_dims: tuple[int, ...], device=None,
                   **plan_kw) -> MeshPlan:
    """Mesh over a scheduled slice of shape ``slice_dims``: what a workload
    calls after the extender placed it (its ranks *are* the slice, in
    row-major order)."""
    return build_mesh(plan_mesh(math.prod(slice_dims), **plan_kw), device=device)


# ---- parameter layout -------------------------------------------------------

def kv_replicated(plan: MeshPlan, config) -> bool:
    """Whether ``wk``/``wv`` are kept whole on every tp rank: when tp does
    not divide the kv heads (GQA with fewer kv heads than tp ranks), each
    rank computes all kv heads and uses those its q heads read."""
    return config is not None and config.n_kv_heads % plan.size("tp") != 0


def param_specs(plan: MeshPlan, config=None) -> dict:
    """Megatron-style tp layout of the model's parameter tree, as axis
    names per dimension: ``wq``/``wk``/``wv``/``w_gate``/``w_up`` split
    their output features (column parallel), ``wo``/``w_down`` their input
    features (row parallel), ``lm_head`` the vocab; the stacked layer axis
    over ``pp`` (each stage holds its own layers).  Under an MoE config
    the FFN leaves are ``moe``'s: the router replicated, the expert tables
    split over ``ep`` on the expert axis and over ``tp`` on ``d_ff``.  The
    reference's layout exactly, with one deviation: where
    :func:`kv_replicated`, ``wk``/``wv`` are replicated (the reference lets
    XLA reshard a split that cuts kv heads apart)."""
    s = plan.spec
    pp = "pp" if plan.size("pp") > 1 else None

    def layer(*names):
        return s(pp, *names)

    kv = layer(None, None) if kv_replicated(plan, config) else layer(None, "tp")
    layers = {
        "attn_norm": layer(None),
        "wq": layer(None, "tp"),
        "wk": kv,
        "wv": kv,
        "wo": layer("tp", None),
        "mlp_norm": layer(None),
    }
    if config is not None and config.moe is not None:
        layers["moe"] = {
            "router": layer(None, None),
            "w_gate": layer("ep", None, "tp"),
            "w_up": layer("ep", None, "tp"),
            "w_down": layer("ep", "tp", None),
        }
    else:
        layers.update({
            "w_gate": layer(None, "tp"),
            "w_up": layer(None, "tp"),
            "w_down": layer("tp", None),
        })
    return {
        "embed": s(None, None),
        "layers": layers,
        "final_norm": s(None),
        "lm_head": s(None, "tp"),
    }


def batch_sharding(plan: MeshPlan) -> tuple:
    """Token batches: batch over dp, sequence over sp."""
    return plan.spec("dp", "sp")


def local_batch(plan: MeshPlan, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch ``tokens`` [B, S]: dp rank
    ``d`` takes the ``d``-th of dp equal blocks of rows."""
    return shard_leaf(tokens, batch_sharding(plan), plan)


def shard_leaf(full: torch.Tensor, spec: tuple, plan: MeshPlan) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``, as a fresh tensor
    (never a view: the step updates its shards in place)."""
    out = full
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = plan.size(axis)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"split over {axis}={n}")
        out = out.chunk(n, dim)[plan.rank(axis)]
    return out.clone(memory_format=torch.contiguous_format)


def gather_leaf(local: torch.Tensor, spec: tuple, plan: MeshPlan) -> torch.Tensor:
    """The whole leaf, as a fresh tensor, from every rank's block under
    ``spec`` (a collective over each splitting axis's group)."""
    out = local.clone(memory_format=torch.contiguous_format)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        parts = [torch.empty_like(out) for _ in range(plan.size(axis))]
        dist.all_gather(parts, out, group=plan.group(axis))
        out = torch.cat(parts, dim)
    return out


def _map(fn, tree: dict, specs: dict) -> dict:
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in tree.items()}


def shard_tree(tree: dict, specs: dict, plan: MeshPlan) -> dict:
    """Every leaf of a full tree cut to this rank's block."""
    return _map(lambda t, s: shard_leaf(t, s, plan), tree, specs)


def gather_tree(tree: dict, specs: dict, plan: MeshPlan) -> dict:
    """The full tree back from every rank's blocks."""
    return _map(lambda t, s: gather_leaf(t, s, plan), tree, specs)


# ---- point-to-point and all-to-all traffic ----------------------------------

#: Calls of the helpers below that staged CUDA tensors through host memory
#: (gloo), and the bytes they staged: read by ``chip_smoke.py``'s rank cases.
HOST_STAGED = {"calls": 0, "bytes": 0}


def _host_staged(group, tensors) -> bool:
    """Whether a collective over ``group`` must stage ``tensors`` through
    host memory: gloo carries all_reduce on CUDA tensors, but not the
    point-to-point, all-to-all, all-gather and broadcast calls here."""
    if not any(t.is_cuda for t in tensors) or dist.get_backend(group) != "gloo":
        return False
    HOST_STAGED["calls"] += 1
    HOST_STAGED["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    return True


def exchange(plan: MeshPlan, axis: str, sends: list, recvs: list) -> None:
    """Point-to-point over ``axis``'s group, all posted at once and waited
    for: ``sends`` holds (tensor, coordinate it goes to) pairs, ``recvs``
    (buffer, coordinate it is filled from) pairs, filled in place."""
    group = plan.group(axis)
    staged = _host_staged(group, [t for t, _ in sends + recvs])
    wire_sends = [(t.cpu() if staged else t.contiguous(), c) for t, c in sends]
    wire_recvs = [(t if t.is_contiguous() and not staged else
                   torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device), c)
                  for t, c in recvs]
    ops = [dist.P2POp(dist.isend, t, plan.peer(axis, c), group) for t, c in wire_sends]
    ops += [dist.P2POp(dist.irecv, t, plan.peer(axis, c), group) for t, c in wire_recvs]
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    for (t, _), (w, _) in zip(recvs, wire_recvs):
        if w is not t:
            t.copy_(w)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` with equal splits of dim 0 (one block per
    rank, block ``j`` to rank ``j``; block ``r`` of the result from rank
    ``r``), as a fresh tensor."""
    x = x.contiguous()
    if _host_staged(group, [x]):
        out = torch.empty_like(x, device="cpu")
        dist.all_to_all_single(out, x.cpu(), group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` over ``group``, in rank order."""
    x = x.contiguous()
    staged = _host_staged(group, [x])
    src = x.cpu() if staged else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if staged else parts


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` from global rank ``src`` of ``group`` on every rank, in place."""
    if _host_staged(group, [x]):
        host = x.cpu()
        dist.broadcast(host, src=src, group=group)
        return x.copy_(host)
    dist.broadcast(x, src=src, group=group)
    return x
