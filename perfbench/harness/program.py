"""What the per-layer readers read of the program's own tracer
(``tputopo_torch.obs``): its export, kept in a traced run's record under
``program_trace``.  A record without that key, such as one of a program
that has no tracer, reads None in every reader."""

from __future__ import annotations

from perfbench.harness.common import percentile

ADMISSIONS = ("admit", "prefill_chunk", "admit_final_chunk")
DECODES = ("decode_step", "decode_steps")


def trace_of(rec: dict) -> dict | None:
    return rec.get("program_trace")


def per_tick(rec: dict, value) -> float | None:
    """``value(export)`` over the serving ticks the export counts."""
    pt = trace_of(rec)
    if not pt or not pt.get("ticks"):
        return None
    v = value(pt)
    return None if v is None else v / pt["ticks"]


def waits_p90(rec: dict, a: str, b: str) -> float | None:
    """The p90 (nearest rank) of request event ``b`` - event ``a`` in
    seconds, over the requests the tracer saw admitted that have both."""
    pt = trace_of(rec)
    if not pt:
        return None
    waits = [(ev[b] - ev[a]) / 1e9 for ev in pt.get("requests", {}).values()
             if "admitted" in ev and a in ev and b in ev]
    return percentile(waits, 0.9)


def replays_under(pt: dict, names: tuple) -> list:
    """(the program span, its replay's ms) for each call of a program in
    ``names`` that a tick made and that replayed its graph (not the call
    that captured it)."""
    parents = {s["id"]: s for s in pt.get("spans", ()) if s["name"] in names
               and s.get("parent") is not None}
    return [(parents[d["parent"]], d["ms"]) for d in pt.get("device", ())
            if d["name"] == "replay" and d.get("call") == "replay"
            and d.get("parent") in parents and d["ms"] is not None]


def replay_decode_ms(rec: dict) -> float | None:
    """The sum of the decode programs' replay ms over the steps they ran."""
    pt = trace_of(rec)
    if not pt:
        return None
    calls = replays_under(pt, DECODES)
    steps = sum(p.get("steps") or 0 for p, _ in calls)
    return sum(ms for _, ms in calls) / steps if steps else None


def replay_prefill_ms_per_ktok(rec: dict) -> float | None:
    """The sum of the admission programs' replay ms per 1000 real prompt tokens
    they took in."""
    pt = trace_of(rec)
    if not pt:
        return None
    calls = replays_under(pt, ADMISSIONS)
    toks = sum(p.get("prompt_tokens") or 0 for p, _ in calls)
    return sum(ms for _, ms in calls) / toks * 1e3 if toks else None


def lap_ms(rec: dict, name: str) -> float | None:
    """The last completed train step's device ms of the lap ``name``."""
    pt = trace_of(rec)
    if not pt:
        return None
    return (pt.get("laps") or {}).get(name)
