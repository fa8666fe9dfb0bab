"""Training through the world-1 sharded step, replayed as its donated
program (``make_sharded_train_step`` on ``mesh_for_slice((1,))``, as
``python -m tputopo_torch train`` drives it), on a new batch each step.

Set-up builds the step and its state and runs the first three steps through
the same call and feed as the window; what the reference is compared with
is read from them: their losses, the first gradient per leaf from the
optimizer's first moment after step 1, and each leaf's change after step 3,
before step 4 overwrites it.
"""

import time

import torch

from perfbench.harness import traffic
from perfbench.harness.common import log
from perfbench.harness.compare import train_gaps
from perfbench.harness.port import model_config
from perfbench.harness.weights import flat, make

CHECKED_STEPS = 3


def run(ctx) -> dict:
    from tputopo_torch.distributed import initialize_from_env, shutdown

    initialize_from_env({}, device=ctx.device.type)
    try:
        return _run(ctx)
    finally:
        shutdown()


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) * scale for k, v in flat(tree).items()}


def _run(ctx) -> dict:
    from tputopo_torch.sharding import mesh_for_slice
    from tputopo_torch.train import TrainState, make_optimizer, make_sharded_train_step

    mix, opt, m = ctx.cell["traffic_mix"], ctx.cell["optimizer"], ctx.model
    plan = mesh_for_slice((1,), device=ctx.device.type, heads=m["num_attention_heads"])
    config = model_config(m)
    params = make(m, ctx.seed, ctx.device)
    state = TrainState(params=params,
                       opt_state=make_optimizer(opt["lr"], opt["weight_decay"]).init(params),
                       step=torch.zeros((), dtype=torch.int32, device=ctx.device))
    del params
    step = make_sharded_train_step(plan, config, lr=opt["lr"])

    def batch(i: int) -> torch.Tensor:
        return torch.from_numpy(traffic.train_batch(mix, ctx.seed, m["vocab_size"], i))

    prog = {"loss": []}
    for i in range(CHECKED_STEPS):
        state, loss = step(state, batch(i))
        prog["loss"].append(float(loss))
        if i == 0:
            prog["grad_norm"] = _norms(state.opt_state.mu, 1.0 / (1.0 - opt["b1"]))
    start = flat(make(m, ctx.seed, ctx.device))
    prog["change_norm"] = {k: float(torch.linalg.vector_norm(v - start[k]))
                           for k, v in flat(state.params).items()}
    del start
    ctx.empty_cache()

    tail = ctx.cell.get("trace_seconds", 2.0)
    stretch = ctx.stretch
    ctx.window_opens()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    k, done, pending = CHECKED_STEPS, 0, None
    while True:
        if stretch is not None and not stretch.running and time.perf_counter() >= end - tail:
            stretch.start()
        state, loss = step(state, batch(k))
        k += 1
        mark = ctx.marks.mark()
        if pending is not None:
            if ctx.cuda:
                pending.synchronize()
            done += 1
        pending = mark
        if time.perf_counter() >= end:
            break
    if ctx.cuda:
        pending.synchronize()
    done += 1
    t_stop = time.perf_counter()
    if stretch is not None and stretch.running:
        stretch.stop()
    window = t_stop - t0
    last_loss = float(loss)
    peak = ctx.memory_peak()
    tokens = done * mix["batch"] * mix["seq"]
    log({"window_s": window, "steps": done, "step_ms": window / done * 1e3,
         "last_loss": last_loss, "setup_losses": prog["loss"]})
    step.programs.release()
    del state, step, loss
    ctx.empty_cache()

    from perfbench.reference import model as ref

    with ref.strict_float32():
        want = ref.train(make(m, ctx.seed, ctx.device),
                         [batch(i).to(ctx.device) for i in range(CHECKED_STEPS)], m, opt)
    gaps = train_gaps(prog, want)
    log({"check": {"program": prog, "reference": want, **gaps}})
    return {"e2e": {"train_tokens_per_s": tokens / window},
            "attempted": done, "failed": 0,
            "record": {"window_s": window, "steps": done, "batch": mix["batch"],
                       "seq": mix["seq"]},
            "checks": {k: gaps[k] for k in ("loss_gap", "grad_gap", "change_gap")},
            "memory_peak_bytes": peak}
