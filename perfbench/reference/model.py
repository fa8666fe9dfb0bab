"""Plain reference of the decoder the configurations describe: a Llama /
Mistral / Mixtral block in float32 PyTorch, with no kernel, cache or
batching of the program's.

It imports torch and nothing else of this repository.  It reads the sizes
from a configuration file's dict and the weights from the dict the benchmark
made (:mod:`perfbench.harness.weights`), in the same layout: stacked
``[L, in, out]`` matmul weights contracted as ``x @ w``.

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``; RoPE on the two halves of a
  head (HF's ``rotate_half``), frequencies ``theta^(-i / (H/2))``; grouped
  query attention, query head n reading kv head n // (N / KV), causal,
  scale 1/sqrt(H); SwiGLU ``(silu(x Wg) * x Wu) Wd``; final norm; head.
- Mixtral's expert layer: softmax router over all experts, top-k, gates
  renormalised over the k (the same as a softmax over the top-k logits).
  Served, every token reaches its k experts.  Trained, the configuration's
  capacity factor seats (token, slot) pairs per expert in (token, slot)
  order, GShard's rule, and a pair past capacity adds nothing; the Switch
  auxiliary loss ``w * E * sum_e(fraction routed to e * mean prob of e)``.
- AdamW as optax's ``adamw``: bias-corrected moments, eps outside the
  square root, decoupled weight decay on every leaf.

Attention runs over blocks of queries, and a training step one batch row
at a time with each layer recomputed in the backward pass, so that the
reference fits beside nothing else on the card.

``low=True`` is the control, one precision step below the configuration's
bfloat16: float8 as Transformer Engine trains in it, every product's
operands rounded to e4m3 forward (attention's q, k, v and probabilities
too) and the gradients flowing into each product to e5m2 backward, one
scale per tensor.
TF32 must be off while the reference runs (:func:`strict_float32`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale for the whole tensor, its
    largest magnitude mapped to the format's largest value."""
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    """An operand of a product rounded to e4m3; its gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """A product's output unchanged; the gradient that flows into it, the
    operand of the backward products, rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, E5M2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """``x @ w``; with ``low``, float8 training as Transformer Engine does
    it: e4m3 operands forward, e5m2 gradients backward, one scale a tensor."""
    if not low:
        return x @ w
    return _Fp8Grad.apply(fp8(x) @ fp8(w))


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, n, H] at positions 0..T-1."""
    T, H = x.shape[1], x.shape[-1]
    half = H // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    c = torch.cos(ang).float()[None, :, None, :]
    s = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(x, p, m, low, qblock=1024):
    B, T, _ = x.shape
    N, KV, H = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    q = rope(mm(x, p["wq"], low).view(B, T, N, H), m["rope_theta"])
    k = rope(mm(x, p["wk"], low).view(B, T, KV, H), m["rope_theta"])
    v = mm(x, p["wv"], low).view(B, T, KV, H)
    k = k.repeat_interleave(N // KV, dim=2)
    v = v.repeat_interleave(N // KV, dim=2)
    if low:
        q, k, v = fp8(q), fp8(k), fp8(v)
    outs = []
    for s0 in range(0, T, qblock):
        s1 = min(T, s0 + qblock)
        sc = torch.einsum("bqnh,bknh->bnqk", q[:, s0:s1], k[:, :s1]) / math.sqrt(H)
        if low:
            sc = _Fp8Grad.apply(sc)
        future = (torch.arange(s1, device=x.device)[None, :]
                  > torch.arange(s0, s1, device=x.device)[:, None])
        pr = torch.softmax(sc.masked_fill(future, float("-inf")), dim=-1)
        if low:
            pr = fp8(pr)
        o = torch.einsum("bnqk,bknh->bqnh", pr, v[:, :s1])
        outs.append(_Fp8Grad.apply(o) if low else o)
    return mm(torch.cat(outs, 1).reshape(B, T, N * H), p["wo"], low)


def capacity(m: dict, tokens: int) -> int:
    """Seats per expert for a group (one batch row) of ``tokens``: tokens x
    k x factor / E, rounded up to a multiple of 8, at least 8 and at most
    the group."""
    raw = tokens * m["num_experts_per_tok"] * m["capacity_factor"] / m["num_local_experts"]
    return max(8, min(int(math.ceil(raw / 8) * 8), tokens))


def experts(x, p, m, low, seated: bool):
    """The expert layer over x [B, T, D] -> (out, aux)."""
    B, T, D = x.shape
    E, k = m["num_local_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(mm(x, p["router"], low), dim=-1)          # [B, T, E]
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    C = capacity(m, T) if seated else None
    rows = []
    for b in range(B):
        flat, g = idx[b].reshape(-1), gates[b].reshape(-1)         # (token, slot) order
        out = torch.zeros_like(x[b])
        for e in range(E):
            sel = (flat == e).nonzero()[:, 0]
            if C is not None:
                sel = sel[:C]
            if sel.numel() == 0:
                continue
            t = sel // k
            xe = x[b, t]
            y = mm(F.silu(mm(xe, p["w_gate"][e], low)) * mm(xe, p["w_up"][e], low),
                   p["w_down"][e], low)
            out = out.index_add(0, t, y * g[sel, None])
        rows.append(out)
    n = B * T
    routed = F.one_hot(idx, E).float().sum((0, 1, 2))
    aux = m["router_aux_loss_coef"] * E * torch.sum((routed / n) * (probs.sum((0, 1)) / n))
    return torch.stack(rows), aux


def block(x, p, m, low, seated):
    eps = m["rms_norm_eps"]
    h = x + attention(rmsnorm(x, p["attn_norm"], eps), p, m, low)
    pre = rmsnorm(h, p["mlp_norm"], eps)
    if "moe" in p:
        y, aux = experts(pre, p["moe"], m, low, seated)
    else:
        y = mm(F.silu(mm(pre, p["w_gate"], low)) * mm(pre, p["w_up"], low),
               p["w_down"], low)
        aux = torch.zeros((), device=x.device)
    return h + y, aux


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights: a per-layer list is indexed, a stacked leaf
    sliced."""
    def take(w):
        return {k: take(v) for k, v in w.items()} if isinstance(w, dict) else w[i]

    return take(params["layers"])


@torch.no_grad()
def logits_at(params: dict, tokens: torch.Tensor, m: dict, want: torch.Tensor,
              low: bool = False, seated: bool = False) -> torch.Tensor:
    """One sequence ``tokens`` [T] through the model -> float32 logits
    [len(want), V] at positions ``want``; experts drop free as served,
    or ``seated`` by capacity as trained."""
    x = params["embed"][tokens][None]
    for i in range(m["num_hidden_layers"]):
        x, _ = block(x, layer_params(params, i), m, low, seated)
    x = rmsnorm(x[0, want], params["final_norm"], m["rms_norm_eps"])
    return mm(x, params["lm_head"], low)


def loss(params: dict, tokens: torch.Tensor, m: dict, low: bool = False) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] (the last position has no
    target), mean over B (S - 1), plus the layers' auxiliary losses; each
    layer recomputed in the backward pass."""
    x = params["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    for i in range(m["num_hidden_layers"]):
        x, a = checkpoint(block, x, layer_params(params, i), m, low, True,
                          use_reentrant=False)
        aux = aux + a
    logits = mm(rmsnorm(x[:, :-1], params["final_norm"], m["rms_norm_eps"]),
                params["lm_head"], low)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.mean() + aux


def leaves(params: dict, prefix: str = "") -> dict:
    """Dotted name -> tensor; per-layer lists named ``<leaf>.<i>``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            out.update({f"{prefix}{k}.{i}": t for i, t in enumerate(v)})
        else:
            out[prefix + k] = v
    return out


def unstack(params: dict) -> dict:
    """The tree with each stacked layer leaf split into a list of per-layer
    tensors (each its own leaf for autograd), freeing the stacked ones."""
    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        parts = [x.clone() for x in t.unbind(0)]
        t.data = torch.empty(0, device=t.device)
        return parts

    return {**params, "layers": split(params["layers"])}


def loss_and_grads(params: dict, batch: torch.Tensor, m: dict, low: bool = False):
    """The batch's loss and the gradient of every leaf (:func:`leaves`
    order), one row at a time where rows do not interact (the auxiliary
    loss of an expert layer couples the rows of a batch)."""
    names = leaves(params)
    for t in names.values():
        t.requires_grad_(True)
    B = batch.shape[0]
    rows = [batch] if ("num_local_experts" in m and B > 1) else list(batch.split(1))
    total, grads = 0.0, None
    for r in rows:
        value = loss(params, r, m, low) * (r.shape[0] / B)
        g = torch.autograd.grad(value, list(names.values()))
        total += float(value.detach())
        grads = list(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
        del value, g
    for t in names.values():
        t.requires_grad_(False)
    return total, dict(zip(names, grads))


@torch.no_grad()
def adamw_(params: dict, grads: dict, state: dict, step: int, opt: dict) -> None:
    """One optax ``adamw`` update of every leaf, in place."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for name, p in leaves(params).items():
        g = grads[name]
        mu, nu = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
        u.add_(p, alpha=opt["weight_decay"])
        p.sub_(u, alpha=opt["lr"])


def stacked_norms(squares: dict) -> dict:
    """Norms of the program's leaves from the reference's per-layer sums of
    squares: ``layers.wq.3`` counts toward ``layers.wq``."""
    sq: dict = {}
    for name, v in squares.items():
        head, _, tail = name.rpartition(".")
        key = head if tail.isdigit() and head.startswith("layers.") else name
        sq[key] = sq.get(key, 0.0) + v
    return {k: math.sqrt(v) for k, v in sq.items()}


def _squares(tensors: dict) -> dict:
    return {k: float(t.double().pow(2).sum()) for k, t in tensors.items()}


def train(params: dict, batches: list, m: dict, opt: dict, low: bool = False) -> dict:
    """``len(batches)`` AdamW steps from ``params`` (stacked; consumed):
    each step's loss, the first step's gradient norm per program leaf, and
    the norm of each leaf's change over all the steps."""
    p = unstack(params)
    start = {k: v.clone() for k, v in leaves(p).items()}
    state: dict = {}
    losses, grad_norms = [], None
    for i, batch in enumerate(batches, start=1):
        value, grads = loss_and_grads(p, batch, m, low)
        losses.append(value)
        if i == 1:
            grad_norms = stacked_norms(_squares(grads))
        adamw_(p, grads, state, i, opt)
        del grads
    state.clear()
    change = {k: float((t - start[k]).double().pow(2).sum())
              for k, t in leaves(p).items()}
    return {"loss": losses, "grad_norm": grad_norms,
            "change_norm": stacked_norms(change)}
