"""Sharding-aware checkpoint/resume for the training workload — the
counterpart of ``tputopo/workloads/checkpoint.py``, on
``torch.distributed.checkpoint`` where the reference uses orbax.

A gang member preempted by the TTL GC or a node failure must resume rather
than restart, and the extender may re-place the gang on another slice.
Each rank saves only its shards: they are wrapped as ``DTensor``s over the
plan's mesh (:func:`torch.distributed.tensor.DTensor.from_local`) for the
save and the load alone, so the checkpoint records global tensors and a
restore onto another plan (another dp x tp layout) reshards.  The training
code itself keeps plain local tensors.

A state's layout under a plan is the model's (:func:`~.sharding.param_specs`
for ``config``) unless ``specs`` gives another tree's, as a LoRA adapter's
TrainState does (:func:`~.lora.lora_shardings`).

Layout: ``<ckpt_dir>/step_<N>/`` per saved step, and ``<ckpt_dir>/params/``
for a serving tree, overwritten in place by every :func:`save_params`.  A
process with no plan (one device) saves and loads its whole tree.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Replicate, Shard

from tputopo_torch.sharding import AXES, MeshPlan, param_specs
from tputopo_torch.train import AdamState, TrainState


def _placements(spec: tuple) -> list:
    """The DTensor placements of a leaf laid out by ``spec`` (axis names
    per dim) on the plan's mesh, one per mesh axis."""
    out = [Replicate()] * len(AXES)
    for dim, axis in enumerate(spec):
        if axis is not None:
            out[AXES.index(axis)] = Shard(dim)
    return out


def _wrap(tree: dict, specs: dict | None, plan: MeshPlan | None) -> dict:
    """``tree``'s local shards as DTensors over ``plan`` (sharing their
    storage, so a load writes into them); the tree itself with no plan."""
    if plan is None:
        return tree
    return {k: _wrap(v, specs[k], plan) if isinstance(v, dict)
            else DTensor.from_local(v, plan.mesh, _placements(specs[k]),
                                    run_check=False)
            for k, v in tree.items()}


def _state_dict(state: TrainState, plan: MeshPlan | None, config,
                specs: dict | None = None) -> dict:
    if plan is not None and specs is None:
        specs = param_specs(plan, config)
    return {
        "params": _wrap(state.params, specs, plan),
        "opt_state": {"count": state.opt_state.count,
                      "mu": _wrap(state.opt_state.mu, specs, plan),
                      "nu": _wrap(state.opt_state.nu, specs, plan)},
        "step": state.step,
    }


def _clear(path: Path) -> None:
    """Remove ``path`` (on rank 0) before a save that overwrites it."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    if dist.is_initialized():
        dist.barrier()


def save(ckpt_dir: str | Path, state: TrainState, plan: MeshPlan | None = None,
         config=None, specs: dict | None = None) -> int:
    """Write one step's checkpoint, this rank's shards of it under ``plan``
    (``config`` names the model whose layout the plan holds, or ``specs``
    gives the state's own layout); returns the step number saved.  Every
    rank of the plan calls it."""
    step = int(state.step)
    path = Path(ckpt_dir).absolute() / f"step_{step}"
    _clear(path)
    dcp.save(_state_dict(state, plan, config, specs), checkpoint_id=path)
    return step


def latest_step(ckpt_dir: str | Path) -> int | None:
    root = Path(ckpt_dir)
    if not root.is_dir():
        return None
    steps = []
    for p in root.iterdir():
        if p.name.startswith("step_"):
            try:
                steps.append(int(p.name[len("step_"):]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, target: TrainState, step: int | None = None,
            plan: MeshPlan | None = None, config=None,
            specs: dict | None = None) -> TrainState | None:
    """Load the latest (or given) step into ``target``, a state laid out on
    the *current* plan (e.g. :func:`~.train.make_sharded_state`), which may
    differ from the plan that saved: the load reshards.  ``target``'s
    tensors are overwritten in place.  Returns None when the directory
    holds no checkpoint (fresh start).  ``specs`` as in :func:`save`."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return None
    sd = _state_dict(target, plan, config, specs)
    dcp.load(sd, checkpoint_id=Path(ckpt_dir).absolute() / f"step_{step}")
    return TrainState(
        params=target.params,
        opt_state=AdamState(count=sd["opt_state"]["count"], mu=target.opt_state.mu,
                            nu=target.opt_state.nu),
        step=sd["step"])


def save_params(ckpt_dir: str | Path, params: dict, plan: MeshPlan | None = None,
                config=None) -> None:
    """Serving deployment: persist a parameter tree — f32 masters, or the
    int8/int4 tree of :func:`~.quant.quantize_params` (int4 leaves as their
    packed ``uint8``).  Overwrites a previous save: the re-quantize-and-
    redeploy flow saves to the same path every time."""
    path = Path(ckpt_dir).absolute() / "params"
    _clear(path)
    specs = param_specs(plan, config) if plan is not None else None
    dcp.save(_wrap(params, specs, plan), checkpoint_id=path)


def restore_params(ckpt_dir: str | Path, target: dict, plan: MeshPlan | None = None,
                   config=None) -> dict | None:
    """Load a tree saved by :func:`save_params` into ``target`` in place
    (build ``target`` with the saved tree's structure: a quantized tree
    loads into a quantized template) and return it; None when nothing was
    saved."""
    path = Path(ckpt_dir).absolute() / "params"
    if not path.is_dir():
        return None
    specs = param_specs(plan, config) if plan is not None else None
    dcp.load(_wrap(target, specs, plan), checkpoint_id=path)
    return target

