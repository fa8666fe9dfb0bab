"""Shared helpers for the PyTorch port's parity tests (``test_torch_*``).

Both packages get the same numbers: a JAX parameter tree goes to numpy,
then through :func:`tputopo_torch.convert.params_from_numpy` into torch,
leaf for leaf, on the CPU; a JAX ``TrainState`` goes through
:func:`tputopo_torch.convert.train_state_from_numpy` with its optax AdamW
moments.  Inputs are made with numpy from a seed.
"""

from __future__ import annotations

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
