"""The model's weights, made by the benchmark from the run's seed, on the
device, and handed alike to the program and to the reference.

The layout is the one both sides read: per-layer tensors stacked on a
leading layer axis, matmul weights ``[in, out]`` contracted as ``x @ w``,
expert tables ``[L, E, in, out]``.  Each leaf is one ``torch.randn`` call on
a generator on the device, scaled by 1/sqrt(fan in), in float32 (the
masters the program keeps; it computes in bfloat16).  Norm weights are
1 + 0.05 N(0, 1), so that a path that skips them shows.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness.common import sub_seed


def shapes(model: dict) -> dict:
    """Leaf name -> (shape, fan_in; fan_in None for a norm weight), in
    draw order."""
    L, D = model["num_hidden_layers"], model["hidden_size"]
    N, KV, F = (model["num_attention_heads"], model["num_key_value_heads"],
                model["intermediate_size"])
    H, V = model["head_dim"], model["vocab_size"]
    out = {"embed": ((V, D), D),
           "layers.attn_norm": ((L, D), None),
           "layers.wq": ((L, D, N * H), D),
           "layers.wk": ((L, D, KV * H), D),
           "layers.wv": ((L, D, KV * H), D),
           "layers.wo": ((L, N * H, D), N * H),
           "layers.mlp_norm": ((L, D), None)}
    E = model.get("num_local_experts")
    if E:
        out.update({"layers.moe.router": ((L, D, E), D),
                    "layers.moe.w_gate": ((L, E, D, F), D),
                    "layers.moe.w_up": ((L, E, D, F), D),
                    "layers.moe.w_down": ((L, E, F, D), F)})
    else:
        out.update({"layers.w_gate": ((L, D, F), D),
                    "layers.w_up": ((L, D, F), D),
                    "layers.w_down": ((L, F, D), F)})
    out.update({"final_norm": ((D,), None), "lm_head": ((D, V), D)})
    return out


def n_params(model: dict) -> int:
    return sum(math.prod(s) for s, _ in shapes(model).values())


def make(model: dict, seed: int, device, into: dict | None = None) -> dict:
    """The nested parameter dict (``{"embed", "layers": {...}, ...}``) drawn
    from ``seed`` on ``device``; with ``into`` (such a dict), each leaf is
    drawn into that dict's tensor in place, so the storage is kept."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    tree: dict = {}
    dest = flat(into) if into is not None else {}
    for name, (shape, fan_in) in shapes(model).items():
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        if fan_in is None:
            w.mul_(0.05).add_(1.0)
        else:
            w.mul_(1.0 / math.sqrt(fan_in))
        if name in dest:
            w = dest[name].copy_(w)
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = w
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    """Dotted leaf name -> tensor."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
