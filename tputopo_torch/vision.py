"""Second model family: a convolutional image classifier — the counterpart
of ``tputopo/workloads/vision.py``.

The reference's only end-to-end workload evidence is MNIST classifiers
trained under both schedulers (Gaia PDF §IV Exp.6); this is that
acceptance workload: a small vision model that must converge on the
scheduled slice, beside the flagship LM.

- Images arrive NHWC, as in the reference.  The convolutions run through
  ``F.conv2d`` on an NCHW view of them, which in memory is
  ``channels_last`` (no copy), with OIHW kernels: the converter turns the
  reference's HWIO kernels around (:func:`~.convert.vision_params_from_numpy`).
  Compute in ``compute_dtype`` (bf16) over f32 params, the LM's policy.
- ``padding="SAME"`` at stride 2 pads asymmetrically: XLA puts the odd
  pad row after (0 before and 1 after at 28 and at 14 with a 3x3 kernel),
  where ``F.conv2d(padding=1)`` would pad 1 on both sides.  So each
  stage pads explicitly (:func:`_same_pad`) and convolves unpadded.
- The flatten before ``fc1`` is in NHWC order, the reference's: the
  activations go back to NHWC before the reshape.
- Data parallel over the plan's ``dp``: parameters replicated, each rank
  takes its block of the batch, computes the mean loss over it, and the
  grads are summed over dp in f32 and divided by dp — the reference's
  global mean for equal blocks.  The optimizer is optax's ``adam``
  (:class:`~.train.Adam`).
- The step :func:`make_vision_train_step` returns is the reference's
  jitted step with params and optimizer state donated: one CUDA-graph
  capture (:func:`~.train.donated_step`) per state storage and batch
  shape, replayed on CUDA (over NCCL under a plan), eager under gloo and
  on the CPU; :func:`vision_train_step` is its body run eagerly.

Synthetic class-conditional data (a bright block at a class-determined
place plus noise) stands in for MNIST: :func:`synthetic_batch` draws the
reference's numpy arrays exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tputopo_torch import _graphs
from tputopo_torch import sharding as shardlib
from tputopo_torch.model import resolve_device
from tputopo_torch.train import Adam, AdamState, donated_step, dp_mean_, loss_and_grads


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 28
    channels: int = 1
    n_classes: int = 10
    widths: tuple = (32, 64)   # conv feature counts, stride-2 stages
    d_hidden: int = 128
    compute_dtype: torch.dtype = torch.bfloat16


def init_vision_params(cfg: VisionConfig, seed: int = 0, *, device=None) -> dict:
    """He-initialized f32 params from a generator seeded with ``seed``, on
    ``device`` (``cuda`` unless asked for the CPU): conv kernels OIHW
    [out, in, 3, 3], dense layers [in, out]."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def he(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(math.sqrt(2.0 / fan_in))

    params = {}
    c_in = cfg.channels
    for i, c_out in enumerate(cfg.widths):
        params[f"conv{i}"] = he((c_out, c_in, 3, 3), 9 * c_in)
        c_in = c_out
    side = cfg.image_size // (2 ** len(cfg.widths))
    flat = side * side * c_in
    params["fc1"] = he((flat, cfg.d_hidden), flat)
    params["fc2"] = he((cfg.d_hidden, cfg.n_classes), cfg.d_hidden)
    return params


def _same_pad(size: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: (before, after), the odd
    row after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def vision_forward(params: dict, images: torch.Tensor,
                   cfg: VisionConfig) -> torch.Tensor:
    """images [B, H, W, C] float -> logits [B, n_classes] f32, on the
    device that holds ``params``."""
    device = params["fc2"].device
    x = torch.as_tensor(images, device=device).to(cfg.compute_dtype)
    x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    for i in range(len(cfg.widths)):
        w = params[f"conv{i}"].to(x.dtype)
        x = F.pad(x, (*_same_pad(x.shape[3]), *_same_pad(x.shape[2])))
        x = F.relu(F.conv2d(x, w, stride=2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
    x = F.relu(x @ params["fc1"].to(x.dtype))
    return x.float() @ params["fc2"]


def synthetic_batch(cfg: VisionConfig, batch: int, seed: int, *,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional structured images, the reference's numpy draws
    exactly: class k gets a bright 6x6 block at a class-determined position
    plus noise.  Returns (images [B, H, W, C] f32, labels [B] int64) on
    ``device`` (``cuda`` unless asked for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.n_classes, batch)
    imgs = rng.normal(0, 0.3, (batch, cfg.image_size, cfg.image_size,
                               cfg.channels)).astype(np.float32)
    for i, k in enumerate(labels):
        r = (k * 2) % (cfg.image_size - 6)
        c = (k * 5) % (cfg.image_size - 6)
        imgs[i, r:r + 6, c:c + 6, :] += 2.0
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev)


def vision_loss(params: dict, images: torch.Tensor, labels: torch.Tensor,
                cfg: VisionConfig) -> torch.Tensor:
    logp = F.log_softmax(vision_forward(params, images, cfg), dim=-1)
    labels = torch.as_tensor(labels, device=logp.device)
    return -logp.gather(-1, labels[:, None]).mean()


def vision_train_step(params: dict, opt_state: AdamState, images: torch.Tensor,
                      labels: torch.Tensor, cfg: VisionConfig, opt: Adam,
                      plan: shardlib.MeshPlan | None = None) -> torch.Tensor:
    """One data-parallel step, eagerly: the mean loss of this rank's block
    ``images``/``labels``, its grads (averaged over the plan's dp, if a
    plan is given), and ``opt``'s update of ``params`` and ``opt_state``
    in place.  Returns the global mean loss."""
    value, grads = loss_and_grads(params, (images, labels), cfg,
                                  loss=lambda p, batch, c: vision_loss(p, *batch, c))
    if plan is not None:
        value = dp_mean_(plan, value, grads)
    opt.update_(grads, opt_state, params)
    return value


def make_vision_train_step(plan: shardlib.MeshPlan | None, cfg: VisionConfig,
                           lr: float = 1e-3):
    """The data-parallel step and its optimizer: ``(step, opt)`` with
    ``step(params, opt_state, images, labels) -> (params, opt_state,
    loss)``, ``images``/``labels`` this rank's block of the batch, the
    params and optimizer state updated in place and the global mean loss
    returned.  With no plan the step runs on one device, with no
    collective.  The step is :func:`vision_train_step` as a donated
    program, a CUDA-graph capture (:func:`~.train.donated_step`), not
    ``torch.jit``, owned by ``step.programs``."""
    opt = Adam(lr=lr)
    programs = _graphs.Programs()
    static = (cfg, lr, None if plan is None else tuple(plan.axes.items()))

    def step(params, opt_state, images, labels):
        state = (params, opt_state)
        loss = donated_step(
            programs, "vision_train_step",
            lambda x, y: vision_train_step(params, opt_state, x, y, cfg, opt, plan), state,
            inputs=(torch.as_tensor(images), torch.as_tensor(labels)), plan=plan,
            device=params["fc2"].device, static=static)
        return params, opt_state, loss

    step.programs = programs
    return step, opt


def train_vision(plan: shardlib.MeshPlan | None, cfg: VisionConfig, *,
                 steps: int = 20, batch: int = 64, lr: float = 1e-3,
                 seed: int = 0, device=None) -> list[float]:
    """Run ``steps`` memorization steps on one synthetic batch and return
    the loss trace (a working setup drives it sharply down, Exp.6-style).
    Under ``plan`` the batch splits over dp on the plan's devices; with no
    plan it runs on ``device`` (``cuda`` unless asked for the CPU)."""
    dev = plan.device if plan is not None else resolve_device(device)
    params = init_vision_params(cfg, seed, device=dev)
    step, opt = make_vision_train_step(plan, cfg, lr)
    opt_state = opt.init(params)
    images, labels = synthetic_batch(cfg, batch, seed, device=dev)
    if plan is not None:
        images = shardlib.shard_leaf(images, plan.spec("dp", None, None, None), plan)
        labels = shardlib.shard_leaf(labels, plan.spec("dp"), plan)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, images, labels)
        losses.append(float(loss))
    return losses
