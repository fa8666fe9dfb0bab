"""Plain reference of DeepSeek-V3's decoder as the ``deepseek-v3-l7-ep32``
configuration cuts it: float32 PyTorch, with no kernel, cache or batching.

It imports torch and nothing else: not the program, not the other reference
modules.  It reads the sizes from the configuration file's dict (the keys of
DeepSeek-V3's ``config.json``) and the weights from the dict the benchmark
made (``perfbench/harness/deepseek.py``): per-layer tensors stacked on a
leading layer axis, matmul weights ``[in, out]`` contracted as ``x @ w``; the
dense FFN's stacked over the ``first_k_dense_replace`` leading layers, the
expert layer's (``moe``) over the rest.

The equations (DeepSeek-V3 technical report §2.1, arXiv:2412.19437; MLA as
in DeepSeek-V2, arXiv:2405.04434 §2.1), token by token with hidden state h:

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``.
- Multi-head latent attention, non-absorbed, exactly as written:
  ``c_q = RMSNorm(h W_qa)``, ``[q_nope, q_pe] = c_q W_qb`` per head;
  ``[c_kv, k_pe] = h W_kva``, ``c_kv = RMSNorm(c_kv)``; ``[k_nope, v] =
  c_kv W_kvb`` per head; q_pe and the shared k_pe rotated by YaRN RoPE; each
  head's ``softmax([q_nope, q_pe] . [k_nope, k_pe] * scale)`` over the causal
  positions times v; ``W_o``.  scale = (nope + rope)^-1/2 * mscale^2, mscale
  = 0.1 * mscale_all_dim * ln(factor) + 1.
- YaRN (arXiv:2309.00071, DeepSeek's ``rope_scaling``): frequency i of
  base^(-2i/rope) kept below the ramp's low dim, divided by ``factor`` above
  its high dim, blended linearly between; low/high the floor/ceil of
  rope * ln(original / (2 pi beta)) / (2 ln base) for beta_fast / beta_slow;
  the tables scaled by mscale(factor, mscale) / mscale(factor,
  mscale_all_dim).  The rope features rotate in adjacent (even, odd) pairs.
- The expert layer (from layer ``first_k_dense_replace`` on): sigmoid scores
  over all ``router_experts``; the choice adds the bias
  ``e_score_correction_bias`` and scores each of ``n_group`` groups by the sum
  of its two best; the top ``topk_group`` groups are kept and the top
  ``num_experts_per_tok`` chosen inside them; the gates are the chosen
  experts' unbiased scores renormalised over them (``norm_topk_prob``) and
  scaled by ``routed_scaling_factor``; each expert a SwiGLU of width
  ``moe_intermediate_size``; the shared experts' SwiGLU (width
  ``n_shared_experts`` x ``moe_intermediate_size``) added for every token.
- The leading dense layers' SwiGLU of width ``intermediate_size``; the final
  norm; the head.

Departures from the published model, each the configuration's:

- Only the experts ``experts_held`` [lo, hi) are computed, as on the chip
  that holds them under expert parallelism: the router chooses over all
  ``router_experts``, a token's pairs with other experts add nothing, and
  that partial result goes on to the next layer.  The shared expert is
  computed in full.
- ``num_hidden_layers`` of the published 61; no multi-token prediction module
  (serving without speculation runs none); float32 masters in place of the
  published FP8 block-quantised weights.
- HF's modeling code permutes the rope features (de-interleaves the pairs)
  before rotating halves; applied to q and k alike, that leaves every score
  as the pairs give it.
- Where ``routes`` is given, token t of expert layer i is sent to the experts
  ``routes[i, t]`` (the program's choices), gated by this reference's own
  scores at those experts; :func:`route_gap` measures how far the given
  choices lie from this reference's own.

Attention runs over blocks of queries, so that at 28k positions it fits on
the card beside nothing else.  ``low=True`` is the control, one precision
step below the configuration's bfloat16: float8 as Transformer Engine runs
it, every product's operands rounded to e4m3 (attention's q, k, v and
probabilities too), one scale per tensor.  TF32 must be off while the
reference runs (:func:`strict_float32`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_float32():
    """float32 matmuls and convolutions in full float32, not TF32."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through e4m3 with one scale for the whole tensor, its largest
    magnitude mapped to the format's largest value."""
    top = torch.finfo(torch.float8_e4m3fn).max
    s = x.abs().amax().clamp_min(1e-30) / top
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    return fp8(x) @ fp8(w) if low else x @ w


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_tables(m: dict, T: int, device) -> tuple:
    """(cos, sin) [T, rope / 2] at positions 0..T-1, in float64 then f32."""
    rope, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    y = m["rope_scaling"]
    factor = float(y["factor"])
    i = torch.arange(rope // 2, dtype=torch.float64, device=device)
    freq = base ** (-2 * i / rope)

    def dim(turns):
        return rope * math.log(y["original_max_position_embeddings"]
                               / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim(y["beta_fast"])), 0)
    high = min(math.ceil(dim(y["beta_slow"])), rope - 1)
    ramp = ((i - low) / (high - low if high > low else 1e-3)).clamp(0, 1)
    freq = freq / factor * ramp + freq * (1 - ramp)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freq[None]
    scale = yarn_mscale(factor, y["mscale"]) / yarn_mscale(factor, y["mscale_all_dim"])
    return (torch.cos(ang) * scale).float(), (torch.sin(ang) * scale).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, n, rope]: pair (2i, 2i+1) rotated by angle i at each position."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).flatten(-2)


def softmax_scale(m: dict) -> float:
    s = yarn_mscale(float(m["rope_scaling"]["factor"]), m["rope_scaling"]["mscale_all_dim"])
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5 * s * s


def attention(x: torch.Tensor, p: dict, m: dict, low: bool, qblock: int = 128):
    """MLA over one sequence x [T, D] -> [T, D], a block of ``qblock``
    queries at a time."""
    T = x.shape[0]
    N, Dn, Dr, Dv = (m["num_attention_heads"], m["qk_nope_head_dim"],
                     m["qk_rope_head_dim"], m["v_head_dim"])
    R, eps = m["kv_lora_rank"], m["rms_norm_eps"]
    cos, sin = rope_tables(m, T, x.device)
    q = mm(rmsnorm(mm(x, p["q_a"], low), p["q_a_norm"], eps), p["q_b"], low).view(T, N, Dn + Dr)
    q = torch.cat([q[..., :Dn], rope(q[..., Dn:], cos, sin)], dim=-1)
    kv = mm(x, p["kv_a"], low)
    c = rmsnorm(kv[:, :R], p["kv_a_norm"], eps)
    k_pe = rope(kv[:, None, R:], cos, sin)                          # [T, 1, rope]
    up = mm(c, p["kv_b"], low).view(T, N, Dn + Dv)
    k = torch.cat([up[..., :Dn], k_pe.expand(T, N, Dr)], dim=-1)   # [T, N, Dn + Dr]
    v = up[..., Dn:].contiguous()
    del kv, c, up
    if low:
        q, k, v = fp8(q), fp8(k), fp8(v)
    scale = softmax_scale(m)
    out = torch.empty(T, N, Dv, device=x.device)
    for s0 in range(0, T, qblock):
        s1 = min(T, s0 + qblock)
        sc = torch.einsum("qnh,knh->nqk", q[s0:s1], k[:s1]).mul_(scale)
        future = (torch.arange(s1, device=x.device)[None, :]
                  > torch.arange(s0, s1, device=x.device)[:, None])
        pr = torch.softmax(sc.masked_fill_(future, float("-inf")), dim=-1)
        del sc
        if low:
            pr = fp8(pr)
        out[s0:s1] = torch.einsum("nqk,knh->qnh", pr, v[:s1])
        del pr
    del q, k, v
    return mm(out.reshape(T, N * Dv), p["wo"], low)


def swiglu(x, wg, wu, wd, low):
    return mm(F.silu(mm(x, wg, low)) * mm(x, wu, low), wd, low)


def group_scores(choice: torch.Tensor, m: dict) -> torch.Tensor:
    """[T, E] biased scores -> [T, n_group]: each group's two best summed."""
    return choice.view(choice.shape[0], m["n_group"], -1).topk(2, dim=-1).values.sum(-1)


def choose(scores: torch.Tensor, bias: torch.Tensor, m: dict) -> torch.Tensor:
    """The experts chosen for each token [T, k] by the group-limited rule."""
    choice = scores + bias
    kept = group_scores(choice, m).topk(m["topk_group"], dim=-1).indices
    allowed = torch.zeros(choice.shape[0], m["n_group"], dtype=torch.bool,
                          device=choice.device).scatter_(1, kept, True)
    allowed = allowed.repeat_interleave(choice.shape[1] // m["n_group"], dim=1)
    return choice.masked_fill(~allowed, float("-inf")).topk(m["num_experts_per_tok"],
                                                           dim=-1).indices


def route_gap(scores: torch.Tensor, bias: torch.Tensor, ids: torch.Tensor, m: dict) -> float:
    """How far given choices ``ids`` [T, k] lie from this reference's own
    under the same rule, in the rule's own units (biased scores): at each
    token, the larger of (a) the reference's last kept group's score less the
    lowest score among the groups the choices fall in, and (b) the
    reference's k-th biased score inside its kept groups less the lowest
    biased score among the chosen experts; 0 where the choices are the
    reference's own (or tie with them); the largest over the tokens."""
    choice = scores + bias
    g = group_scores(choice, m)
    kept = g.topk(m["topk_group"], dim=-1)
    per = choice.shape[1] // m["n_group"]
    group_gap = (kept.values[:, -1:] - g.gather(1, ids // per)).clamp_min(0).amax(-1)
    allowed = torch.zeros_like(g, dtype=torch.bool).scatter_(1, kept.indices, True)
    inside = choice.masked_fill(~allowed.repeat_interleave(per, dim=1), float("-inf"))
    kth = inside.topk(m["num_experts_per_tok"], dim=-1).values[:, -1:]
    expert_gap = (kth - choice.gather(1, ids)).clamp_min(0).amax(-1)
    return float(torch.maximum(group_gap, expert_gap).max())


def experts(x: torch.Tensor, p: dict, m: dict, low: bool, ids=None):
    """The expert layer over x [T, D]: the held experts' pairs and the shared
    expert -> (out [T, D], the router's sigmoid scores [T, E], the ids
    routed)."""
    scores = torch.sigmoid(mm(x, p["router"], low))
    if ids is None:
        ids = choose(scores, p["bias"], m)
    gates = scores.gather(1, ids)
    if m["norm_topk_prob"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * m["routed_scaling_factor"]
    lo, hi = m["experts_held"]
    k = ids.shape[1]
    flat, g = ids.reshape(-1), gates.reshape(-1)
    out = swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"], low)
    for e in range(lo, hi):
        sel = (flat == e).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        t = sel // k
        y = swiglu(x[t], p["w_gate"][e - lo], p["w_up"][e - lo], p["w_down"][e - lo], low)
        out = out.index_add(0, t, y * g[sel, None])
    return out, scores, ids


def layer_params(params: dict, m: dict, i: int) -> dict:
    """Layer ``i``'s weights: the attention's at i, the dense FFN's at i
    below ``first_k_dense_replace``, the expert layer's at i - that above."""
    K = m["first_k_dense_replace"]
    layers = params["layers"]
    p = {k: v[i] for k, v in layers.items() if k not in ("moe", "w_gate", "w_up", "w_down")}
    if i < K:
        p.update({k: layers[k][i] for k in ("w_gate", "w_up", "w_down")})
    else:
        p["moe"] = {k: v[i - K] for k, v in layers["moe"].items()}
    return p


@torch.no_grad()
def hidden(params: dict, tokens: torch.Tensor, m: dict, low: bool = False,
           routes: torch.Tensor | None = None) -> tuple[torch.Tensor, float]:
    """One sequence ``tokens`` [T] through the layers -> (the last layer's
    output [T, D], the largest :func:`route_gap` over the expert layers where
    ``routes`` [L_moe, T, k] gives the choices, else 0)."""
    eps = m["rms_norm_eps"]
    x = params["embed"][tokens]
    gap = 0.0
    for i in range(m["num_hidden_layers"]):
        p = layer_params(params, m, i)
        h = x + attention(rmsnorm(x, p["attn_norm"], eps), p, m, low)
        pre = rmsnorm(h, p["mlp_norm"], eps)
        if "moe" in p:
            K = m["first_k_dense_replace"]
            ids = None if routes is None else routes[i - K]
            y, scores, ids = experts(pre, p["moe"], m, low, ids)
            if routes is not None:
                gap = max(gap, route_gap(scores, p["moe"]["bias"], ids, m))
        else:
            y = swiglu(pre, p["w_gate"], p["w_up"], p["w_down"], low)
        x = h + y
    return x, gap


@torch.no_grad()
def logits_at(params: dict, tokens: torch.Tensor, m: dict, want: torch.Tensor,
              low: bool = False, routes: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, float]:
    """float32 logits [len(want), V] at positions ``want`` of ``tokens`` [T],
    and the route gap (:func:`hidden`)."""
    x, gap = hidden(params, tokens, m, low, routes)
    x = rmsnorm(x[want], params["final_norm"], m["rms_norm_eps"])
    return mm(x, params["lm_head"], low), gap
