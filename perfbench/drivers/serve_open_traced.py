"""Serving under open-loop arrivals, as ``serve_open``, with what the program
records of itself:

- with ``--trace 1`` the engine carries a ``tputopo_torch.obs.Tracer`` from
  before its captures, so every captured program holds the program's own
  spans and counters; the profiler stretch's start and stop each snapshot
  the counters the tracer carries (the routed expert layer's ``moe`` counts
  and the grouped GEMM's launches), and the record keeps both snapshots
  (``stretch_counts``) beside the tracer's export (``program_trace``);
- for a configuration with experts, the engine keeps each finished
  request's expert choices (``record_routes``), and the check replays them
  into the reference (:mod:`perfbench.harness.routed`): ``served_gap`` at
  the program's routing and ``route_gap``, how far its choices lie from the
  reference's own.  A program whose engine cannot keep them stops at once,
  with no result.
"""

import inspect
import sys
import time

from perfbench.harness import routed, serving, traffic
from perfbench.harness.common import log
from perfbench.harness.port import engine_class, model_config
from perfbench.harness.weights import make

# What the tracer carries that the per-layer readers take deltas of.
COUNTED = ("moe", "grouped_mm")


def build(ctx, **kw):
    """The engine for the cell (as :func:`perfbench.harness.serving.build`),
    with the program's own options ``kw``."""
    s = ctx.cell["engine"]
    by_rid = ctx.by_rid

    def on_tokens(rid, toks):
        t = time.perf_counter()
        r = by_rid.get(rid)
        if r is None:          # a warm-up request
            return
        if r.first is None:
            r.first = t
        r.last = t
        r.tokens.extend(toks)

    return engine_class()(ctx.params, ctx.config, slots=s["slots"],
                          max_len=s["max_len"], prompt_pad=tuple(s["prompt_pad"]),
                          prefill_chunk=s.get("prefill_chunk"),
                          steps_per_tick=s.get("steps_per_tick", 1),
                          eos_id=-1, temperature=0.0, on_tokens=on_tokens, **kw)


def counted(tracer) -> dict:
    """The counters the tracer carries now, of :data:`COUNTED` (a program
    that has none gives an empty dict)."""
    out = tracer.export()
    return {k: out[k] for k in COUNTED if k in out}


def snapshot_stretch(ctx, tracer) -> dict:
    """Make the stretch's start and stop snapshot the tracer's counters,
    each after the device has caught up; the snapshots land in the dict
    returned."""
    marks = {}
    stretch = ctx.stretch
    start, stop = stretch.start, stretch.stop

    def start_counted():
        ctx.sync()
        marks["start"] = counted(tracer)
        start()

    def stop_counted():
        stop()
        marks["stop"] = counted(tracer)

    stretch.start, stretch.stop = start_counted, stop_counted
    return marks


def run(ctx) -> dict:
    experts = bool(ctx.model.get("num_local_experts"))
    opts = {}
    if experts:
        from tputopo_torch.serving import ServingEngine

        if "record_routes" not in inspect.signature(ServingEngine.__init__).parameters:
            log("the program's ServingEngine cannot keep its expert choices "
                "(record_routes): the check has nothing to replay")
            sys.exit(3)
        opts["record_routes"] = True
    ctx.config = model_config(ctx.model)
    ctx.params = make(ctx.model, ctx.seed, ctx.device)
    engine = build(ctx, **opts)
    tracer = None
    if ctx.trace:
        from tputopo_torch.obs import Tracer

        tracer = engine.tracer = Tracer()
    serving.warm(ctx, engine)
    reqs = traffic.requests(ctx.cell["traffic_mix"], ctx.seed, ctx.model["vocab_size"],
                            ctx.seconds)
    ctx.window_opens()
    marks = snapshot_stretch(ctx, tracer) if tracer is not None else None
    out = serving.run_window(ctx, engine, reqs)
    peak = ctx.memory_peak()
    rec = serving.record(ctx, out)
    if tracer is not None:
        rec["program_trace"] = tracer.export()
        rec["stretch_counts"] = marks
    kept = None
    if experts:
        # a request that finished in the window's last tick is harvested,
        # and its choices copied out, at the start of the next tick
        engine.step()
        kept = routed.host_routes(engine)
    serving.free(ctx, engine)
    if experts:
        checks = routed.check(ctx, kept, out["done"], ctx.cell["check"])
        compared = {k: checks[k] for k in ("served_gap", "route_gap")}
    else:
        checks = serving.check(ctx, out["done"], ctx.cell["check"])
        compared = {"served_gap": checks["served_gap"]}
    log({"check": checks})
    return {"e2e": serving.end_to_end(out), "attempted": len(out["due"]),
            "failed": out["failed"], "record": rec, "checks": compared,
            "memory_peak_bytes": peak}
