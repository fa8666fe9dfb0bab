"""Serving a queue that never drains (as ``serve_backlog``) on a DeepSeek-V3
configuration, with what the program records of itself (as
``serve_open_traced``):

- the engine keeps each finished request's expert choices
  (``record_routes``), and the check replays them into DeepSeek's plain
  reference (:func:`perfbench.harness.deepseek.gaps`): ``served_gap`` at the
  program's routing and ``route_gap``, how far its choices lie from the
  reference's own under the same rule;
- with ``--trace 1`` the engine carries a ``tputopo_torch.obs.Tracer`` from
  before its captures, and the profiler stretch's start and stop each
  snapshot the counters it carries (latent attention's ``mla``, the routed
  layer's ``moe``, the grouped GEMM's launches) into the record (``stretch_counts``) beside the tracer's
  export (``program_trace``); the benchmark's own program spans
  (``programs``) cover the window.

A program without latent attention (no ``ModelConfig.mla``) cannot run the
configuration: the run stops at once, with no result.
"""

import sys

from perfbench.harness import deepseek, routed, serving, traffic
from perfbench.harness.common import log
from perfbench.harness.port import EngineTrace

# What the tracer carries that the per-layer readers take deltas of.
COUNTED = ("mla", "moe", "grouped_mm")


def supported() -> bool:
    """Whether the program has latent attention to serve the configuration."""
    from tputopo_torch.model import ModelConfig

    return "mla" in ModelConfig.__dataclass_fields__


def counted(tracer) -> dict:
    out = tracer.export()
    return {k: out[k] for k in COUNTED if k in out}


def snapshot_stretch(ctx, tracer) -> dict:
    """Make the stretch's start and stop snapshot the tracer's counters, each
    after the device has caught up; the snapshots land in the dict returned."""
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


def serve(ctx) -> tuple[dict, dict, int, dict]:
    """Set the engine up (weights from the seed, captures, the first
    ``slots`` requests admitted), serve the window, let the engine go ->
    (the window's record of requests, the per-layer record, the peak device
    bytes, the kept expert choices by request id)."""
    from perfbench.drivers.serve_open_traced import build

    ctx.config = deepseek.model_config(ctx.model)
    ctx.params = deepseek.make(ctx.model, ctx.seed, ctx.device)
    engine = build(ctx, record_routes=True)
    tracer = None
    if ctx.trace:
        from tputopo_torch.obs import Tracer

        tracer = engine.tracer = Tracer()
    serving.warm(ctx, engine)
    reqs = traffic.requests(ctx.cell["traffic_mix"], ctx.seed, ctx.model["vocab_size"],
                            ctx.seconds)
    started = serving.fill(ctx, engine, reqs, ctx.cell["engine"]["slots"])
    if ctx.trace:
        ctx.engine_trace = engine.trace = EngineTrace(ctx.marks)
    captured = sum(engine.programs.captures.values())
    ctx.window_opens()
    marks = snapshot_stretch(ctx, tracer) if tracer is not None else None
    out = serving.run_window(ctx, engine, reqs, backlog=ctx.cell["backlog"],
                             started=started)
    peak = ctx.memory_peak()
    # every program (one a prefill chunk's end) is captured in set-up
    log({"captures_before_window": captured,
         "captures_in_window": sum(engine.programs.captures.values()) - captured})
    rec = serving.record(ctx, out)
    if tracer is not None:
        rec["program_trace"] = tracer.export()
        rec["stretch_counts"] = marks
    # a request that finished in the window's last tick is harvested, and
    # its choices copied out, at the start of the next tick
    engine.step()
    kept = routed.host_routes(engine)
    serving.free(ctx, engine)
    engine.params = None
    del engine
    ctx.empty_cache()
    return out, rec, peak, kept


def check(ctx, out: dict, kept: dict, control: bool = False) -> dict:
    """:func:`perfbench.harness.deepseek.gaps` over the sample the seed draws
    from the finished requests."""
    rid_of = {id(r): rid for rid, r in ctx.by_rid.items()}
    sample = serving.choose(ctx.seed, out["done"], ctx.cell["check"])
    return deepseek.gaps(ctx.params, ctx.model, sample, rid_of, kept, ctx.device, control)


def run(ctx) -> dict:
    if not supported():
        log("the program has no latent attention (ModelConfig.mla): it cannot serve "
            "DeepSeek-V3")
        sys.exit(3)
    out, rec, peak, kept = serve(ctx)
    checks = check(ctx, out, kept)
    log({"check": checks})
    return {"e2e": serving.end_to_end(out), "attempted": len(out["due"]),
            "failed": out["failed"], "record": rec,
            "checks": {k: checks[k] for k in ("served_gap", "route_gap")},
            "memory_peak_bytes": peak}
