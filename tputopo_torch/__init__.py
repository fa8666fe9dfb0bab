"""tputopo_torch — the PyTorch/CUDA port of ``tputopo.workloads``.

The package mirrors the JAX package module for module and runs on an
NVIDIA H100; the JAX package stays the reference it is tested against.
It carries the Llama-family LM's forward (:func:`forward`), with
attention through hand-written sm_90a CUDA flash-attention kernels forward
and backward, one-shot KV-cache decoding (:func:`generate`), the
continuous-batching :class:`ServingEngine`, int8/int4 weight and int8
KV-cache quantization (:func:`quantize_params`, :func:`streamed_bytes`),
and the single-device AdamW training step (:func:`train_step`).  It imports
neither JAX nor anything of ``tputopo``.
"""

from tputopo_torch.convert import params_from_numpy, train_state_from_numpy
from tputopo_torch.decode import KVCache, generate
from tputopo_torch.model import ModelConfig, forward, init_params
from tputopo_torch.quant import quantize_params, streamed_bytes
from tputopo_torch.serving import ServingEngine
from tputopo_torch.train import TrainState, loss_fn, make_train_state, train_step

__all__ = ["KVCache", "ModelConfig", "ServingEngine", "TrainState", "forward",
           "generate", "init_params", "loss_fn", "make_train_state",
           "params_from_numpy", "quantize_params", "streamed_bytes",
           "train_state_from_numpy", "train_step"]
