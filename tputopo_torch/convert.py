"""Parameter trees from numpy — how the port takes over weights from the
JAX package (or from any source that can hand over numpy arrays).

The tree is nested dicts of numpy arrays in the reference's layout
(``init_params``: stacked ``[L, in, out]`` matmul weights); the result is
the same tree of torch tensors, leaf for leaf, so both packages compute
the same function on the same numbers.  A quantized tree
(``quantize_params``) comes across too: int8 leaves as they are, grouped
int4 leaves (ml_dtypes ``int4``, which torch cannot take) through int8
into the port's packed form (:func:`~.quant.pack_int4`).
:func:`train_state_from_numpy`
carries a training run across: the parameters with optax's AdamW moments
and step count, for the model's tree or a LoRA adapter's
(:func:`lora_from_numpy`).  :func:`sharded_params_from_numpy` carries a
tree onto a mesh plan: the whole tree converted, then cut to this rank's
shards.  :func:`vision_params_from_numpy` carries the conv classifier's
tree, its kernels turned from the reference's HWIO to torch's OIHW.
"""

from __future__ import annotations

import numpy as np
import torch

from tputopo_torch.model import resolve_device
from tputopo_torch.quant import is_quantized, pack_int4
from tputopo_torch.train import AdamState, TrainState


def _leaf(a, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; f32 holds it exactly.
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, *, device=None, dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (``cuda`` by default, see :func:`~.model.resolve_device`);
    floating leaves are cast to ``dtype`` when it is given, except the
    scales of quantized leaves, which stay float32 as in the reference."""
    dev = resolve_device(device)
    if is_quantized(tree):
        return {k: (pack_int4(torch.from_numpy(np.asarray(v).astype(np.int8))).to(dev)
                    if k == "int4" else _leaf(v, dev, None))
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=dev, dtype=dtype)
                for k, v in tree.items()}
    return _leaf(tree, dev, dtype)


def train_state_from_numpy(params, mu, nu, count, step, *,
                           device=None) -> TrainState:
    """A JAX ``TrainState`` as numpy: its ``params`` tree, the ``mu``,
    ``nu`` and ``count`` of its optax ``ScaleByAdamState``, and its
    ``step`` -> the port's :class:`~.train.TrainState` on ``device``."""
    dev = resolve_device(device)

    def scalar(x) -> torch.Tensor:
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(
        params=params_from_numpy(params, device=dev),
        opt_state=AdamState(count=scalar(count),
                            mu=params_from_numpy(mu, device=dev),
                            nu=params_from_numpy(nu, device=dev)),
        step=scalar(step))


def lora_from_numpy(tree, *, device=None) -> dict:
    """A LoRA adapter tree (``init_lora``'s ``{"layers": {target: {"a",
    "b", "scale"}}}``) as numpy -> the same tree of f32 tensors on
    ``device``; its TrainState goes through :func:`train_state_from_numpy`."""
    return params_from_numpy(tree, device=device, dtype=torch.float32)


def vision_params_from_numpy(tree, *, device=None) -> dict:
    """The conv classifier's params (``init_vision_params``) as numpy ->
    tensors on ``device``: each ``conv<i>`` kernel from HWIO [3, 3, in, out]
    to OIHW [out, in, 3, 3], the dense layers as they are."""
    dev = resolve_device(device)
    return {k: (_leaf(v, dev, None).permute(3, 2, 0, 1).contiguous()
                if k.startswith("conv") else _leaf(v, dev, None))
            for k, v in tree.items()}


def sharded_params_from_numpy(tree, plan, config, *,
                              dtype: torch.dtype | None = None) -> dict:
    """This rank's shards of a whole numpy parameter tree under ``plan``
    (:func:`~.sharding.param_specs` for ``config``), on the plan's device."""
    from tputopo_torch.sharding import param_specs, shard_tree

    full = params_from_numpy(tree, device=plan.device, dtype=dtype)
    return shard_tree(full, param_specs(plan, config), plan)
