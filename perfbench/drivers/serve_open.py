"""Serving under open-loop arrivals: requests arrive on the mix's schedule,
whatever the engine's state, and each is timed from when it was due."""

from perfbench.harness import serving, traffic
from perfbench.harness.common import log
from perfbench.harness.port import EngineTrace, model_config
from perfbench.harness.weights import make


def run(ctx) -> dict:
    ctx.config = model_config(ctx.model)
    ctx.params = make(ctx.model, ctx.seed, ctx.device)
    engine = serving.build(ctx)
    serving.warm(ctx, engine)
    reqs = traffic.requests(ctx.cell["traffic_mix"], ctx.seed, ctx.model["vocab_size"],
                            ctx.seconds)
    if ctx.trace:
        ctx.engine_trace = engine.trace = EngineTrace(ctx.marks)
    ctx.window_opens()
    out = serving.run_window(ctx, engine, reqs)
    peak = ctx.memory_peak()
    rec = serving.record(ctx, out)
    serving.free(ctx, engine)
    checks = serving.check(ctx, out["done"], ctx.cell["check"])
    log({"check": checks})
    return {"e2e": serving.end_to_end(out), "attempted": len(out["due"]),
            "failed": out["failed"], "record": rec,
            "checks": {"served_gap": checks["served_gap"]}, "memory_peak_bytes": peak}
