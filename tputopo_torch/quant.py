"""Weight-only quantization for the serving path — the counterpart of
``tputopo/workloads/quant.py``.

A weight is a plain tensor in the stacked ``[..., in, out]`` layout,
contracted as ``x @ w``, or a quantized leaf:

- int8, ``{"int8": q, "scale": s}``: symmetric absmax per output channel
  for matmul weights (over ``in``, the axis kept at size 1), per row for
  the gathered embedding; ``s`` is float32.
- grouped int4, ``{"int4": p, "scale": s}``: the ``in`` axis split into
  ``G`` groups of ``g`` rows, one absmax scale per group and output
  column, ``s`` ``[..., G, 1, out]`` float32.  Torch has no 4-bit dtype,
  so ``p`` packs two values per ``uint8`` along ``out``: ``[..., G, g,
  out / 2]``, byte ``j`` holding column ``2j`` in its low nibble and
  column ``2j + 1`` in its high nibble, each a two's-complement 4-bit
  integer in [-7, 7] (:func:`pack_int4`).  ``out`` is even for every
  matmul weight of the model (head widths, ``d_ff``, ``d_model``, the
  vocabulary), while ``g`` is odd wherever the group-size walk degrades
  on an odd ``in``, so ``out`` is the axis that packs without padding.

Quantized values and scales are bit-exact against the reference: the same
float32 operations in the same order, and ``torch.round`` rounds half to
even as ``jnp.round`` does.  The matmuls dequantize in the reference's
order: int8 as ``(x @ q) * s`` in ``x``'s dtype, int4 as f32 per-group
partials, the group sum, then one cast.  A LoRA leaf
(``{"lora_base", "lora_a", "lora_b", "lora_scale"}``, :mod:`.lora`) is its
frozen base, itself raw or quantized, plus the low-rank delta.

A raw weight is cast to the compute dtype where it is used.  A server whose
weights stay fixed holds them there once instead (:func:`compute_params`).
"""

from __future__ import annotations

import warnings

import torch

#: Weight names quantized in the stacked-layer tree.  Norm weights stay
#: float32: they are O(D), and streaming them quantized saves nothing.
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "q_a", "q_b", "kv_a", "kv_b")
_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down")


def is_quantized(w) -> bool:
    """True for a quantized-leaf dict (``int8`` or grouped ``int4``)."""
    return isinstance(w, dict) and ("int8" in w or "int4" in w)


def _is_int4(w) -> bool:
    return isinstance(w, dict) and "int4" in w


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values held in an integer tensor ``[..., n]`` (n even) -> uint8
    ``[..., n / 2]``: column ``2j`` in byte ``j``'s low nibble, ``2j + 1``
    in its high nibble, two's complement."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, got shape "
                         f"{tuple(q.shape)}")
    nib = q.to(torch.int16) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``[..., m]`` -> int8 ``[..., 2m]``."""
    b = p.to(torch.int16)
    nib = torch.stack((b & 0xF, b >> 4), dim=-1)
    nib = nib - ((nib & 8) << 1)  # sign-extend the 4-bit values
    return nib.reshape(*p.shape[:-1], 2 * p.shape[-1]).to(torch.int8)


def _quantize_leaf(w: torch.Tensor, axis: int) -> dict:
    """Symmetric absmax int8 over ``axis`` (kept), scale in float32.  Zero
    channels get scale 1/127, so q is exactly 0 and dequant exact."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax, 1.0) / 127.0
    q = (w / scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"int8": q, "scale": scale.float()}


def _quantize_leaf4(w: torch.Tensor, group: int) -> dict:
    """Grouped symmetric int4 over the contraction axis (``-2``): ``in``
    splits into groups of ``group`` rows (walked down to a divisor), each
    with its own absmax scale; the values are packed (:func:`pack_int4`)."""
    *lead, din, dout = w.shape
    g = max(1, min(group, din))
    while din % g:
        g -= 1
    if g < min(group, din) and g < 8:
        # The divisor walk collapsed (e.g. a prime input dim): with
        # near-per-element f32 scales the "int4" tree streams MORE bytes
        # than bf16.
        warnings.warn(
            f"int4 group size degraded to {g} for input dim {din} "
            f"(requested {group}); scales now dominate the stream — "
            "pick a group_size dividing the model's inner dims",
            stacklevel=2)
    wg = w.reshape(*lead, din // g, g, dout)
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax, 1.0) / 7.0
    q = (wg / scale).round_().clamp_(-7, 7)
    return {"int4": pack_int4(q), "scale": scale.float()}


@torch.no_grad()
def quantize_params(params: dict, *, bits: int = 8,
                    group_size: int = 128) -> dict:
    """Quantize an LM parameter tree (``init_params`` layout) for serving,
    on the device that holds it; the input tree is left as it is.

    ``bits=8``: matmul weights ``[.., in, out]`` per output channel, the
    embedding per row.  ``bits=4``: matmul weights grouped int4 with
    ``group_size`` input rows per scale; the embedding stays int8 per row
    (it is gathered, not streamed).  Norm weights stay float32."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if "kv_b" in params["layers"]:
        raise ValueError("quantized weights have no latent attention (MLA) support")

    def mat(w):
        return (_quantize_leaf(w, axis=-2) if bits == 8
                else _quantize_leaf4(w, group_size))

    out = _map_matmul_weights(params, mat)
    out["embed"] = _quantize_leaf(params["embed"], axis=-1)
    return out


def _map_matmul_weights(params: dict, fn) -> dict:
    """The tree with ``fn`` applied to each raw matmul weight, the weights
    serving casts whole to the compute dtype before use: the layers'
    projections (an MLA layer's too), the expert and shared-expert tables,
    ``lm_head``, and a LoRA leaf's
    ``lora_base``.  Every other leaf is shared: the norms and the router
    (used in f32), the embedding (gathered, then cast), the adapters and
    quantized leaves."""
    def leaf(w):
        if isinstance(w, dict) and "lora_base" in w:
            return dict(w, lora_base=leaf(w["lora_base"]))
        return w if is_quantized(w) else fn(w)

    layers = dict(params["layers"])
    for name in _LAYER_WEIGHTS:
        if name in layers:
            layers[name] = leaf(layers[name])
    if "moe" in layers:
        layers["moe"] = dict(layers["moe"], **{
            name: leaf(layers["moe"][name]) for name in _EXPERT_WEIGHTS
            if name in layers["moe"]})
    return dict(params, layers=layers, lm_head=leaf(params["lm_head"]))


@torch.no_grad()
def compute_params(params: dict, dtype: torch.dtype) -> dict:
    """``params`` with each weight that serving casts whole to ``dtype``
    before use (:func:`_map_matmul_weights`) held as a contiguous copy at
    ``dtype``; the input tree is left as it is and every other leaf is
    shared.  The stacked ``[L, ...]`` layout is kept, so a layer's slice is
    a view already at ``dtype``, and the consumers' ``.to(dtype)`` returns
    it with no kernel: the products see the values and strides a per-call
    cast gives them."""
    return _map_matmul_weights(params, lambda w: w if w.dtype == dtype else w.to(
        dtype, memory_format=torch.contiguous_format))


def compute_bytes(params: dict, dtype: torch.dtype) -> int:
    """Device bytes :func:`compute_params` allocates for ``params``."""
    sizes = []

    def record(w):
        if w.dtype != dtype:
            sizes.append(w.numel() * dtype.itemsize)
        return w

    _map_matmul_weights(params, record)
    return sum(sizes)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a raw, quantized or LoRA-wrapped weight.

    Raw: the weight cast to ``x``'s dtype first.  int8: ``(x @ q) * s`` in
    ``x``'s dtype, the per-output-channel scale applied after the
    contraction.  Grouped int4 must be sliced first, to a packed ``[G, g,
    out / 2]`` with no leading layer axis: the group einsum's ellipsis belongs to
    ``x``'s batch dims, so a stacked leaf is rejected; it runs in f32
    throughout and casts once, after the group sum.  LoRA: the base dot
    plus ``(x @ a) @ b * scale`` in f32 (a and b are the f32 masters being
    trained), cast once to the base dot's dtype."""
    if isinstance(w, dict) and "lora_base" in w:
        base = qdot(x, w["lora_base"])
        delta = (x.float() @ w["lora_a"]) @ w["lora_b"] * w["lora_scale"]
        return base + delta.to(base.dtype)
    if _is_int4(w):
        if w["int4"].dim() > 3:
            raise ValueError(
                f"qdot int4 weight has leading axes (packed shape "
                f"{tuple(w['int4'].shape)}; want [groups, group, out/2]): "
                "scan-slice the stacked leaf before qdot, or use deq()")
        q = unpack_int4(w["int4"]).float()   # [G, g, O]
        s = w["scale"].squeeze(-2)            # [G, O] f32
        G, g = q.shape[-3], q.shape[-2]
        xg = x.reshape(*x.shape[:-1], G, g).float()
        part = torch.einsum("...Gg,Ggo->...Go", xg, q)
        return (part * s).sum(dim=-2).to(x.dtype)
    if is_quantized(w):
        s = w["scale"].squeeze(-2).to(x.dtype)
        return (x @ w["int8"].to(x.dtype)) * s
    return x @ w.to(x.dtype)


def deq(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight materialized at ``dtype``; grouped int4 merges its (G, g)
    axes back into ``in``."""
    if _is_int4(w):
        wf = unpack_int4(w["int4"]).to(dtype) * w["scale"].to(dtype)
        return wf.reshape(*wf.shape[:-3], wf.shape[-3] * wf.shape[-2],
                          wf.shape[-1])
    if is_quantized(w):
        return w["int8"].to(dtype) * w["scale"].to(dtype)
    return w.to(dtype)


def deq_rows(w, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row gather (embedding lookup) from a raw or row-quantized table, at
    ``dtype``.  Gathering first and casting the rows equals casting the
    table and then gathering (the cast is elementwise), and reads only the
    rows."""
    if is_quantized(w):
        return w["int8"][idx].to(dtype) * w["scale"][idx].to(dtype)
    return w[idx].to(dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K or V rows for an int8 KV cache: symmetric absmax over head_dim
    (last axis, kept), one f32 scale per (batch, position, kv-head)."""
    d = _quantize_leaf(x, axis=-1)
    return d["int8"], d["scale"]


def fold_kv_scale(s: torch.Tensor) -> torch.Tensor:
    """[B, S, KV, 1] cache scales -> [B, KV, 1, 1, S], the broadcast layout
    of the grouped-GQA attention einsums' ``bkgts`` output."""
    return s[..., 0].movedim(1, -1)[:, :, None, None, :]


def streamed_bytes(params: dict, compute_itemsize: int = 2) -> int:
    """Bytes a decode step streams from device memory for this tree, as the
    port stores it: quantized leaves their int8 bytes, or their packed int4
    bytes, plus f32 scales; raw matmul weights (layers and ``lm_head``) at
    the compute dtype's ``compute_itemsize``; norms at f32.  The embedding
    (gathered, O(batch) rows) is left out."""
    matmul_names = _LAYER_WEIGHTS + ("lm_head",)

    def leaf_bytes(name: str, v) -> int:
        if _is_int4(v):
            return v["int4"].numel() + v["scale"].numel() * 4
        if is_quantized(v):
            return v["int8"].numel() + v["scale"].numel() * 4
        return v.numel() * (compute_itemsize if name in matmul_names else 4)

    def walk(tree: dict) -> int:
        return sum(walk(v) if isinstance(v, dict) and not is_quantized(v)
                   else leaf_bytes(k, v) for k, v in tree.items())

    return (walk(params["layers"]) + leaf_bytes("final_norm", params["final_norm"])
            + leaf_bytes("lm_head", params["lm_head"]))
