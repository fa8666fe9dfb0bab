"""The check of a served expert model with the program's expert choices
replayed into the reference (:mod:`perfbench.reference.routed`).

The engine keeps each finished request's choices (``record_routes``: the
top-k expert ids at every layer and position it fed through the layers).
Over the sample :func:`perfbench.harness.serving.choose` draws, the reference
computes each compared sequence at those choices and reads two numbers:

- ``served_gap``: as the dense cells' (:func:`perfbench.harness.serving.gaps`),
  the widest gap by which a served token's reference logit lies below the
  reference's best at its position, now at the program's routing;
- ``route_gap``: the widest margin by which a chosen expert's reference
  probability lies below the reference's own k-th (0 where the program
  chose the reference's top k), over every layer and position compared.

A request whose choices are missing, or hold a position never written
(-1), reads an infinite gap.
"""

from __future__ import annotations

from perfbench.harness import serving


def host_routes(engine) -> dict:
    """The engine's kept choices, by request id, on the host (after the
    window: a readback)."""
    return {rid: t.cpu() for rid, t in engine.routes.items()}


def gaps(params: dict, model: dict, sample: list, rid_of: dict, routes: dict, device,
         control: bool = False) -> dict:
    """``served_gap`` and ``route_gap`` over ``sample`` (``Served`` records;
    ``rid_of`` maps each to its request id, ``routes`` an id to its
    choices [L, positions, k]); with ``control``, also ``control_gap``: how
    far below the best lies the token the float8 reference, at the same
    choices, puts first."""
    from perfbench.reference import model as ref
    from perfbench.reference import routed

    out = {"served_gap": 0.0, "route_gap": 0.0, "compared_tokens": 0,
           "compared_requests": len(sample)}
    if control:
        out["control_gap"] = 0.0
    if not sample:
        out["served_gap"] = out["route_gap"] = float("inf")
        return out
    with ref.strict_float32():
        for r in sample:
            seq, want, picked = serving.sequence(r.req.prompt, r.tokens, device)
            ids = routes.get(rid_of.get(id(r)))
            if ids is None or ids.shape[1] != seq.shape[0] or bool((ids < 0).any()):
                out["served_gap"] = out["route_gap"] = float("inf")
                continue
            ids = ids.to(device=device, dtype=seq.dtype)
            logits, rgap = routed.logits_at(params, seq, model, want, ids)
            best = logits.max(-1).values
            gap = best - logits.gather(1, picked[:, None])[:, 0]
            out["served_gap"] = max(out["served_gap"], float(gap.max()))
            out["route_gap"] = max(out["route_gap"], rgap)
            out["compared_tokens"] += len(r.tokens)
            if control:
                low = routed.logits_at(params, seq, model, want, ids, low=True)[0].argmax(-1)
                cgap = best - logits.gather(1, low[:, None])[:, 0]
                out["control_gap"] = max(out["control_gap"], float(cgap.max()))
            del logits
    return out


def check(ctx, routes: dict, done: list, check_cfg: dict, control: bool = False) -> dict:
    """:func:`gaps` over the sample the seed draws from the finished
    requests (:func:`perfbench.harness.serving.choose`)."""
    rid_of = {id(r): rid for rid, r in ctx.by_rid.items()}
    sample = serving.choose(ctx.seed, done, check_cfg)
    return gaps(ctx.params, ctx.model, sample, rid_of, routes, ctx.device, control)
