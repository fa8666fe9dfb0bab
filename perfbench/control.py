"""Read a cell's control on the chip: the plain reference computed in
float8 in the program's place (``reference.model``'s ``low``), one
precision step below the configuration's bfloat16, and the same numbers a
run compares.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 30]

Serving cells: one process sets the engine up once; for each seed it draws
that seed's weights into the same storage (the captured programs stay
valid), serves the seed's traffic for the window, drains, and over the
sample a run would compare reads the served tokens' widest gap (the
program's reading) and, at the same positions of the same sequences, the
widest gap of the token the float8 reference puts first (the control's).
Training cells: for each seed the reference trains its three steps in
float32 and in float8 from the seed's weights and batches, and the control
reads as a run's numbers would: the float8 steps against the float32 ones.
Where the batch has rows to halve, the fault "half the batch left out, the
mean taken over the rest" is read the same way, planted in the reference.

One JSON line a seed.  Nothing here runs in the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness.common import log, set_environment, workload  # noqa: E402


def serving_control(cell: dict, seeds: list, seconds: float, device) -> None:
    from perfbench.harness import serving, traffic
    from perfbench.harness.core import Context
    from perfbench.harness.port import model_config
    from perfbench.harness.weights import make

    ctx = Context(cell, seeds[0], seconds, False, device, T_START)
    ctx.config = model_config(ctx.model)
    ctx.params = make(ctx.model, ctx.seed, device)
    engine = serving.build(ctx)
    serving.warm(ctx, engine)
    backlog = cell.get("backlog") if cell["driver"] == "serve_backlog" else None
    for seed in seeds:
        ctx.seed = seed
        make(ctx.model, seed, device, into=ctx.params)
        reqs = traffic.requests(cell["traffic_mix"], seed, ctx.model["vocab_size"], seconds)
        started = (serving.fill(ctx, engine, reqs, cell["engine"]["slots"])
                   if backlog is not None else None)
        out = serving.run_window(ctx, engine, reqs, backlog=backlog, started=started)
        engine.run()
        sample = serving.choose(seed, out["done"], cell["check"])
        read = serving.gaps(ctx.params, ctx.model, sample, device, control=True)
        print(json.dumps({"seed": seed, **read}), flush=True)


def training_control(cell: dict, seeds: list, device) -> None:
    import torch

    from perfbench.harness import traffic
    from perfbench.harness.compare import train_gaps
    from perfbench.harness.weights import make
    from perfbench.reference import model as ref

    m, mix, opt = cell["model"], cell["traffic_mix"], cell["optimizer"]
    for seed in seeds:
        batches = [torch.from_numpy(traffic.train_batch(mix, seed, m["vocab_size"], i)).to(device)
                   for i in range(3)]
        keys = ("loss_gap", "grad_gap", "change_gap")
        with ref.strict_float32():
            want = ref.train(make(m, seed, device), batches, m, opt)
            low = ref.train(make(m, seed, device), batches, m, opt, low=True)
            gaps = train_gaps(low, want)
            row = {"seed": seed, "control": {k: gaps[k] for k in keys},
                   "by_leaf": {"grad": gaps["grad_gap_by_leaf"],
                               "change": gaps["change_gap_by_leaf"]},
                   "losses": {"f32": want["loss"], "fp8": low["loss"]}}
            B = mix["batch"]
            if B >= 2:   # the fault "half the batch left out", planted in the reference
                half = ref.train(make(m, seed, device), [b[: B // 2] for b in batches], m, opt)
                row["fault_half_batch"] = {k: v for k, v in train_gaps(half, want).items()
                                           if k in keys}
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    cell = workload(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    if cell["driver"] == "train":
        training_control(cell, seeds, device)
    else:
        serving_control(cell, seeds, args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
