"""Shared helpers for the PyTorch port's parity tests (``test_torch_*``).

Both packages get the same numbers: a JAX parameter tree goes to numpy,
then through :func:`tputopo_torch.convert.params_from_numpy` into torch,
leaf for leaf, on the CPU.  Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from tputopo_torch.convert import params_from_numpy


def to_torch(jax_tree, dtype: torch.dtype | None = None) -> dict:
    """A JAX parameter tree as the port's dict of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, jax_tree), device="cpu",
                             dtype=dtype)


def normal(shape, seed: int = 0, n: int = 3) -> tuple[np.ndarray, ...]:
    """``n`` float32 standard-normal arrays of ``shape`` from ``seed``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(n))
