"""tputopo_torch — the PyTorch/CUDA port of ``tputopo.workloads``.

The package mirrors the JAX package module for module and runs on an
NVIDIA H100; the JAX package stays the reference it is tested against.
This slice carries the Llama-family LM's inference forward
(:func:`forward`), with attention through a hand-written sm_90a CUDA
flash-attention kernel, and one-shot KV-cache decoding
(:func:`generate`).  It imports neither JAX nor anything of ``tputopo``.
"""

from tputopo_torch.convert import params_from_numpy
from tputopo_torch.decode import KVCache, generate
from tputopo_torch.model import ModelConfig, forward, init_params

__all__ = ["KVCache", "ModelConfig", "forward", "generate", "init_params",
           "params_from_numpy"]
