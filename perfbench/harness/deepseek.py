"""DeepSeek-V3 as the benchmark drives it: a configuration file with DeepSeek's
``config.json`` keys turned into the program's ``ModelConfig`` (latent
attention, the leading dense layers, the group-limited sigmoid router, the
shared expert and the share of the routed experts this chip holds), the
weights made from the run's seed in the layout both the program and the
plain reference (:mod:`perfbench.reference.deepseek`) read, and the check of
what the engine served with its expert choices replayed into the reference.

The layout: per-layer tensors stacked on a leading layer axis, matmul
weights ``[in, out]``; the attention's over all layers, the dense FFN's
over the ``first_k_dense_replace`` leading ones, the expert layer's
(``layers.moe``) over the rest, its tables over the held experts only.  Each
leaf is one ``torch.randn`` on a generator on the device, N(0, 1/fan_in) for
a matmul weight, 1 + 0.05 N(0, 1) for a norm weight, and for the router's
bias ``e_score_correction_bias`` N(0, ``router_bias_std``^2).
"""

from __future__ import annotations

import math

import torch

from perfbench.harness.common import sub_seed


def model_config(model: dict):
    """The program's ``ModelConfig`` for a DeepSeek configuration file's dict."""
    from tputopo_torch.mla import MLAConfig
    from tputopo_torch.model import ModelConfig
    from tputopo_torch.moe import MoEConfig

    if (model["scoring_func"], model["topk_method"], model["norm_topk_prob"]) != \
            ("sigmoid", "noaux_tc", True):
        raise ValueError("the program routes as DeepSeek-V3 does: sigmoid scores, "
                         "noaux_tc, gates renormalised")
    lo, hi = model["experts_held"]
    if hi - lo != model["n_routed_experts"]:
        raise ValueError("n_routed_experts counts the experts held: experts_held's")
    y = model["rope_scaling"]
    mla = MLAConfig(q_rank=model["q_lora_rank"], kv_rank=model["kv_lora_rank"],
                    nope=model["qk_nope_head_dim"], rope=model["qk_rope_head_dim"],
                    v=model["v_head_dim"], factor=float(y["factor"]),
                    original=y["original_max_position_embeddings"],
                    beta_fast=float(y["beta_fast"]), beta_slow=float(y["beta_slow"]),
                    mscale=float(y["mscale"]), mscale_all_dim=float(y["mscale_all_dim"]))
    moe = MoEConfig(n_experts=model["router_experts"], top_k=model["num_experts_per_tok"],
                    first_dense=model["first_k_dense_replace"],
                    d_expert=model["moe_intermediate_size"],
                    n_shared=model["n_shared_experts"], held=(lo, hi), scoring="sigmoid",
                    n_group=model["n_group"], topk_group=model["topk_group"],
                    routed_scale=float(model["routed_scaling_factor"]))
    return ModelConfig(vocab_size=model["vocab_size"], d_model=model["hidden_size"],
                       n_layers=model["num_hidden_layers"],
                       n_heads=model["num_attention_heads"],
                       n_kv_heads=model["num_key_value_heads"],
                       d_ff=model["intermediate_size"],
                       max_seq=model["max_position_embeddings"],
                       rope_theta=float(model["rope_theta"]),
                       norm_eps=model["rms_norm_eps"], moe=moe, mla=mla)


NORM, BIAS = "norm", "bias"


def shapes(model: dict) -> dict:
    """Leaf name -> (shape, fan_in, or :data:`NORM` / :data:`BIAS`), in draw
    order."""
    L, D, V = model["num_hidden_layers"], model["hidden_size"], model["vocab_size"]
    N, Rq, R = model["num_attention_heads"], model["q_lora_rank"], model["kv_lora_rank"]
    Dn, Dr, Dv = model["qk_nope_head_dim"], model["qk_rope_head_dim"], model["v_head_dim"]
    K, F, Fe = model["first_k_dense_replace"], model["intermediate_size"], \
        model["moe_intermediate_size"]
    Lm, E, Eh = L - K, model["router_experts"], model["n_routed_experts"]
    Fs = model["n_shared_experts"] * Fe
    return {"embed": ((V, D), D),
            "layers.attn_norm": ((L, D), NORM),
            "layers.q_a": ((L, D, Rq), D),
            "layers.q_a_norm": ((L, Rq), NORM),
            "layers.q_b": ((L, Rq, N * (Dn + Dr)), Rq),
            "layers.kv_a": ((L, D, R + Dr), D),
            "layers.kv_a_norm": ((L, R), NORM),
            "layers.kv_b": ((L, R, N * (Dn + Dv)), R),
            "layers.wo": ((L, N * Dv, D), N * Dv),
            "layers.mlp_norm": ((L, D), NORM),
            "layers.w_gate": ((K, D, F), D),
            "layers.w_up": ((K, D, F), D),
            "layers.w_down": ((K, F, D), F),
            "layers.moe.router": ((Lm, D, E), D),
            "layers.moe.bias": ((Lm, E), BIAS),
            "layers.moe.w_gate": ((Lm, Eh, D, Fe), D),
            "layers.moe.w_up": ((Lm, Eh, D, Fe), D),
            "layers.moe.w_down": ((Lm, Eh, Fe, D), Fe),
            "layers.moe.shared_gate": ((Lm, D, Fs), D),
            "layers.moe.shared_up": ((Lm, D, Fs), D),
            "layers.moe.shared_down": ((Lm, Fs, D), Fs),
            "final_norm": ((D,), NORM),
            "lm_head": ((D, V), D)}


def n_params(model: dict) -> int:
    return sum(math.prod(s) for s, _ in shapes(model).values())


def make(model: dict, seed: int, device, into: dict | None = None) -> dict:
    """The nested parameter dict drawn from ``seed`` on ``device``; with
    ``into`` (such a dict), each leaf is drawn into its tensor in place."""
    from perfbench.harness.weights import flat

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    tree: dict = {}
    dest = flat(into) if into is not None else {}
    for name, (shape, kind) in shapes(model).items():
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        if kind == NORM:
            w.mul_(0.05).add_(1.0)
        elif kind == BIAS:
            w.mul_(model["router_bias_std"])
        else:
            w.mul_(1.0 / math.sqrt(kind))
        if name in dest:
            w = dest[name].copy_(w)
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = w
    return tree


def gaps(params: dict, model: dict, sample: list, rid_of: dict, routes: dict, device,
         control: bool = False) -> dict:
    """``served_gap`` and ``route_gap`` over ``sample`` (``Served`` records,
    ``rid_of`` their request ids, ``routes`` an id to the program's choices
    [L_moe, positions, k]), as :func:`perfbench.harness.routed.gaps` reads
    them for Mixtral, with DeepSeek's reference; with ``control``, also
    ``control_gap``, the float8 reference's first token at the same choices."""
    from perfbench.harness import serving
    from perfbench.reference import deepseek as ref

    out = {"served_gap": 0.0, "route_gap": 0.0, "compared_tokens": 0,
           "compared_requests": len(sample)}
    if control:
        out["control_gap"] = 0.0
    if not sample:
        out["served_gap"] = out["route_gap"] = float("inf")
        return out
    with ref.strict_float32():
        for r in sample:
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()  # each sequence's blocks, not the last one's
            seq, want, picked = serving.sequence(r.req.prompt, r.tokens, device)
            ids = routes.get(rid_of.get(id(r)))
            if ids is None or ids.shape[1] != seq.shape[0] or bool((ids < 0).any()):
                out["served_gap"] = out["route_gap"] = float("inf")
                continue
            ids = ids.to(device=device, dtype=torch.long)
            logits, rgap = ref.logits_at(params, seq, model, want, routes=ids)
            best = logits.max(-1).values
            gap = best - logits.gather(1, picked[:, None])[:, 0]
            out["served_gap"] = max(out["served_gap"], float(gap.max()))
            out["route_gap"] = max(out["route_gap"], rgap)
            out["compared_tokens"] += len(r.tokens)
            if control:
                low = ref.logits_at(params, seq, model, want, low=True, routes=ids)[0]
                cgap = best - logits.gather(1, low.argmax(-1)[:, None])[:, 0]
                out["control_gap"] = max(out["control_gap"], float(cgap.max()))
                del low
            del logits
    return out
