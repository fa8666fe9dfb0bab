"""The system under test, ``tputopo_torch``, as the benchmark drives it: the
configuration file turned into the program's ``ModelConfig``, and the
serving engine with the benchmark's own spans around its device programs.

The spans are taken from the benchmark's side: a subclass of the program's
``ServingEngine`` wraps :meth:`_program`, the one place the engine calls
device work, and records a pair of marks (CUDA events on the card) around
each call, with the prompt tokens an admission program takes in and the
decode steps a decode program runs.  If the program renames what is
wrapped, the metric that reads it finds nothing and reports nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def model_config(model: dict):
    """The program's ``ModelConfig`` for a configuration file's dict."""
    from tputopo_torch.model import ModelConfig
    from tputopo_torch.moe import MoEConfig

    if model["hidden_size"] != model["num_attention_heads"] * model["head_dim"]:
        raise ValueError("the program derives head_dim as hidden_size / heads")
    moe = None
    if model.get("num_local_experts"):
        moe = MoEConfig(n_experts=model["num_local_experts"],
                        top_k=model["num_experts_per_tok"],
                        capacity_factor=model["capacity_factor"],
                        aux_loss_weight=model["router_aux_loss_coef"])
    return ModelConfig(vocab_size=model["vocab_size"], d_model=model["hidden_size"],
                       n_layers=model["num_hidden_layers"],
                       n_heads=model["num_attention_heads"],
                       n_kv_heads=model["num_key_value_heads"],
                       d_ff=model["intermediate_size"],
                       max_seq=model["max_position_embeddings"],
                       rope_theta=float(model["rope_theta"]),
                       norm_eps=model["rms_norm_eps"], moe=moe)


class Marks:
    """Paired marks around device work: CUDA events on the card (read once
    the window has closed), the host clock elsewhere."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class ProgramSpan:
    name: str
    start: object
    end: object
    prompt_tokens: int | None = None   # admissions: real prompt tokens taken in
    first_pos: int | None = None       # admissions: position of the first of them
    steps: int | None = None           # decode programs: steps run


@dataclass
class EngineTrace:
    marks: Marks
    programs: list = field(default_factory=list)


def _describe(engine, name: str, args: tuple) -> dict:
    """What an engine program call does, from its arguments as
    ``ServingEngine`` passes them; empty when they are not as expected."""
    try:
        if name == "admit":          # (params, state, config, slot, padded, plen, ...)
            return {"prompt_tokens": int(args[5]), "first_pos": 0}
        if name == "prefill_chunk":  # (params, state, config, slot, chunk, start)
            plen = engine._prefilling[args[3]][2]
            start = int(args[5])
            return {"prompt_tokens": min(int(args[4].shape[0]), plen - start),
                    "first_pos": start}
        if name == "admit_final_chunk":  # (..., slot, row, chunk, start, plen, ...)
            return {"prompt_tokens": int(args[7]) - int(args[6]),
                    "first_pos": int(args[6])}
        if name == "decode_step":
            return {"steps": 1}
        if name == "decode_steps":   # (params, state, config, eos, n)
            return {"steps": int(args[4])}
    except (IndexError, KeyError, TypeError, AttributeError):
        pass
    return {}


def engine_class():
    """The program's ``ServingEngine`` with the benchmark's spans: set
    ``trace`` to an :class:`EngineTrace` to record them."""
    from tputopo_torch.serving import ServingEngine

    class BenchEngine(ServingEngine):
        trace: EngineTrace | None = None

        def _program(self, name, *args, **kw):
            tr = self.trace
            if tr is None:
                return super()._program(name, *args, **kw)
            info = _describe(self, name, args)
            a = tr.marks.mark()
            out = super()._program(name, *args, **kw)
            tr.programs.append(ProgramSpan(name, a, tr.marks.mark(), **info))
            return out

    return BenchEngine
