"""tputopo_torch — the PyTorch/CUDA port of ``tputopo.workloads``.

The package mirrors the JAX package module for module and runs on NVIDIA
H100s; the JAX package stays the reference it is tested against.  It
carries the Llama-family LM's forward (:func:`forward`), with attention
through hand-written sm_90a CUDA flash-attention kernels forward and
backward, one-shot KV-cache decoding (:func:`generate`), the
continuous-batching :class:`ServingEngine`, int8/int4 weight and int8
KV-cache quantization (:func:`quantize_params`, :func:`streamed_bytes`),
and training: the single-device AdamW step (:func:`train_step`) and the
DP x TP sharded step over a gang of processes, one per GPU
(:func:`make_sharded_train_step` on a :class:`MeshPlan`, after
:func:`initialize_from_env`), with the all-reduce acceptance measurement
against an H100 link model (:func:`measure_allreduce`,
:func:`validate_slice`), token-corpus shards (:class:`TokenDataset`) and
checkpoints that restore onto another plan (:mod:`.checkpoint`).  On one
GPU it also carries speculative decoding (:func:`spec_generate`,
:class:`SpecServingEngine`), LoRA/QLoRA adapters (:mod:`.lora`) and the
conv classifier (:mod:`.vision`).  The parallelism strategies run
beside dp and tp: Mixture-of-Experts layers with experts over ``ep``
(:class:`MoEConfig`, :mod:`.moe`), the GPipe pipeline over ``pp``
(:mod:`.pipeline`), and ring and all-to-all context parallelism over
``sp`` (:mod:`.ring`, :mod:`.ulysses`).  The reference's ``jax.jit``
programs keep their names as CUDA-graph captures (:mod:`._graphs`): the
serving engines', ``generate_jit``, ``forward_jit``, the speculative
programs and the jitted training steps, their state donated.  ``python -m tputopo_torch
allreduce|train|decode|serve|train-vision`` is the in-container entry
point.  It imports neither JAX nor anything of ``tputopo``.
"""

from tputopo_torch.collective import AllReduceResult, measure_allreduce
from tputopo_torch.convert import params_from_numpy, train_state_from_numpy
from tputopo_torch.data import TokenDataset
from tputopo_torch.decode import KVCache, generate
from tputopo_torch.distributed import initialize_from_env, process_group_from_env
from tputopo_torch.model import ModelConfig, forward, forward_with_aux, init_params
from tputopo_torch.moe import MoEConfig
from tputopo_torch.quant import quantize_params, streamed_bytes
from tputopo_torch.lora import init_lora, lora_view, merge_lora
from tputopo_torch.serving import ServingEngine
from tputopo_torch.sharding import MeshPlan, build_mesh, mesh_for_slice, plan_mesh
from tputopo_torch.speculative import SpecServingEngine, spec_generate
from tputopo_torch.train import (TrainState, loss_fn, make_sharded_state,
                                 make_sharded_train_step, make_train_state, train_step)
from tputopo_torch.validate import validate_slice
from tputopo_torch.vision import VisionConfig, train_vision

__all__ = ["AllReduceResult", "KVCache", "MeshPlan", "ModelConfig", "MoEConfig",
           "ServingEngine", "SpecServingEngine", "TokenDataset", "TrainState",
           "VisionConfig", "build_mesh", "forward", "forward_with_aux", "generate",
           "init_lora", "init_params",
           "initialize_from_env", "lora_view", "loss_fn", "make_sharded_state",
           "make_sharded_train_step", "make_train_state", "measure_allreduce",
           "merge_lora", "mesh_for_slice", "params_from_numpy", "plan_mesh",
           "process_group_from_env", "quantize_params", "spec_generate",
           "streamed_bytes", "train_state_from_numpy", "train_step", "train_vision",
           "validate_slice"]
