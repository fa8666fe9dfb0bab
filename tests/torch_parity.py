"""Shared helpers for the PyTorch port's parity tests (``test_torch_*``).

Both packages get the same numbers: a JAX parameter tree goes to numpy,
then through :func:`tputopo_torch.convert.params_from_numpy` into torch,
leaf for leaf, on the CPU; a JAX ``TrainState`` goes through
:func:`tputopo_torch.convert.train_state_from_numpy` with its optax AdamW
moments.  Inputs are made with numpy from a seed.

Multi-process tests run their ranks with :func:`run_ranks`: ``world``
processes of ``tests/torch_dist_workers.py`` over gloo, meeting on a
``FileStore`` in the test's own directory (no TCP port to race for).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import torch

from tputopo_torch.convert import params_from_numpy, train_state_from_numpy
from tputopo_torch.train import TrainState


def to_torch(jax_tree, dtype: torch.dtype | None = None) -> dict:
    """A JAX parameter tree as the port's dict of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, jax_tree), device="cpu",
                             dtype=dtype)


def adam_state(jax_state) -> optax.ScaleByAdamState:
    """The ``ScaleByAdamState`` inside an optax ``adamw`` chain's state."""
    return next(s for s in jax.tree.leaves(
        jax_state.opt_state, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def train_state_to_torch(jax_state) -> TrainState:
    """A JAX ``TrainState`` as the port's, on the CPU."""
    adam = jax.tree.map(np.asarray, adam_state(jax_state))
    return train_state_from_numpy(
        jax.tree.map(np.asarray, jax_state.params), adam.mu, adam.nu,
        adam.count, np.asarray(jax_state.step), device="cpu")


def normal(shape, seed: int = 0, n: int = 3) -> tuple[np.ndarray, ...]:
    """``n`` float32 standard-normal arrays of ``shape`` from ``seed``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(n))


REPO = Path(__file__).resolve().parent.parent
WORKERS = REPO / "tests" / "torch_dist_workers.py"


def run_ranks(job: str, world: int, workdir, args: dict | None = None,
              env_for=None, timeout: float = 150.0) -> list[dict]:
    """Run ``job`` of ``tests/torch_dist_workers.py`` in ``world`` processes
    and return each rank's result.  ``env_for(rank)`` adds env variables;
    every rank runs one CPU thread."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "args.json").write_text(json.dumps(args or {}))
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **(env_for(rank) if env_for else {}))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKERS), job, str(rank), str(world), str(workdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errors = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {rank} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        raise AssertionError("\n".join(errors))
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world)]


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of this process alone, for the length of the
    block (the port's single-process group)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
