"""The plain reference with an expert layer's choices given from outside: the
Mixtral block of :mod:`perfbench.reference.model` in float32, each token of
each layer sent to the experts the program chose for it, and a measure of
how far those choices lie from the reference's own.

Random routers put a token's k-th and (k+1)-th experts near a tie, where the
program's bfloat16 and the reference's float32 choose differently and the
token's output moves by a whole expert's share.  Given the program's
choices, the reference computes the same mixture as the program, each
expert's gate from its own float32 router (the probabilities at the chosen
experts, renormalised over them), so what is left between the two sides is
the program's rounding.  The choices themselves are held apart by
:func:`route_gap`.

It imports torch and the plain reference, nothing else of this repository.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref


def experts_at(x, p, m: dict, ids: torch.Tensor, low: bool):
    """The expert layer over x [1, T, D] with token t sent to experts
    ``ids[t]`` ([T, k] int64), gated by this reference's router: the
    softmax over all experts, taken at the given ids and renormalised over
    them -> (out [1, T, D], the router's probabilities [T, E])."""
    probs = torch.softmax(ref.mm(x[0], p["router"], low), dim=-1)
    k = ids.shape[1]
    gates = probs.gather(1, ids)
    gates = gates / gates.sum(-1, keepdim=True)
    flat, g = ids.reshape(-1), gates.reshape(-1)
    out = torch.zeros_like(x[0])
    for e in range(m["num_local_experts"]):
        sel = (flat == e).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        t = sel // k
        xe = x[0, t]
        y = ref.mm(F.silu(ref.mm(xe, p["w_gate"][e], low)) * ref.mm(xe, p["w_up"][e], low),
                   p["w_down"][e], low)
        out = out.index_add(0, t, y * g[sel, None])
    return out[None], probs


def route_gap(probs: torch.Tensor, ids: torch.Tensor) -> float:
    """How far given choices lie below the reference's own top k: at each
    token, the k-th largest probability less the smallest probability
    among the chosen experts (0 where the choices are the top k, or tie
    with it), the largest over the tokens.  A chosen expert named twice
    reads as the (k+1)-th or a lower one."""
    k = ids.shape[1]
    top = probs.topk(k, dim=-1).values[:, -1]
    chosen = probs.gather(1, ids)
    twice = (ids[:, :, None] == ids[:, None, :]).sum(-1) > 1
    least = torch.where(twice, torch.zeros_like(chosen), chosen).min(-1).values
    return float((top - least).clamp_min(0).max())


@torch.no_grad()
def logits_at(params: dict, tokens: torch.Tensor, m: dict, want: torch.Tensor,
              routes: torch.Tensor, low: bool = False) -> tuple[torch.Tensor, float]:
    """One sequence ``tokens`` [T] through the model with layer i's token t
    sent to experts ``routes[i, t]`` ([L, T, k] int64) -> (float32 logits
    [len(want), V] at positions ``want``, the largest :func:`route_gap` over
    the layers).  With ``low``, the control: float8 products, as
    :func:`perfbench.reference.model.logits_at`'s."""
    eps = m["rms_norm_eps"]
    x = params["embed"][tokens][None]
    gap = 0.0
    for i in range(m["num_hidden_layers"]):
        p = ref.layer_params(params, i)
        h = x + ref.attention(ref.rmsnorm(x, p["attn_norm"], eps), p, m, low)
        y, probs = experts_at(ref.rmsnorm(h, p["mlp_norm"], eps), p["moe"], m, routes[i], low)
        gap = max(gap, route_gap(probs, routes[i]))
        x = h + y
    x = ref.rmsnorm(x[0, want], params["final_norm"], eps)
    return ref.mm(x, params["lm_head"], low), gap
