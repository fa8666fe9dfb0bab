"""Find a serving cell's knee once, on the chip: the highest offered rate
at which the engine's waiting queue does not grow over the window.

    python3 perfbench/sweep.py --workload mistral7b.chat --rates 1,2,3,4 --seconds 30

One process sets the cell up once and then, for each rate in turn, offers
the cell's traffic mix at that rate for the window and drains the engine.
It prints one JSON line a rate (the queue's mean depth over the first and
the last third of the window, TTFT and TPOT percentiles, completed rate)
and, last, the knee and 0.8 of it, the rate a cell below the knee runs at.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness.common import log, percentile, set_environment, workload  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    from perfbench.harness import serving, traffic
    from perfbench.harness.core import Context
    from perfbench.harness.port import model_config
    from perfbench.harness.weights import make

    cell = workload(args.workload)
    ctx = Context(cell, args.seed, args.seconds, False, torch.device("cuda", 0), T_START)
    ctx.config = model_config(ctx.model)
    ctx.params = make(ctx.model, ctx.seed, ctx.device)
    engine = serving.build(ctx)
    serving.warm(ctx, engine)
    knee = None
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell["traffic_mix"], arrival={**cell["traffic_mix"]["arrival"], "rate": rate})
        reqs = traffic.requests(mix, args.seed + k, ctx.model["vocab_size"], args.seconds)
        out = serving.run_window(ctx, engine, reqs)
        engine.run()
        q = out["queue"]
        third = args.seconds / 3
        first = [d for t, d in q if t < third]
        last = [d for t, d in q if t >= 2 * third]
        grows = (sum(last) / max(1, len(last))) > (sum(first) / max(1, len(first))) + 1.0
        row = {"rate": rate, "due": len(out["due"]), "completed": len(out["done"]),
               "completed_rate": len(out["done"]) / out["window_s"],
               "queue_first_third": sum(first) / max(1, len(first)),
               "queue_last_third": sum(last) / max(1, len(last)), "queue_grows": grows,
               "ttft_p50_s": percentile(out["ttft"], 0.5),
               "ttft_p90_s": percentile(out["ttft"], 0.9),
               "tpot_p50_ms": percentile(out["tpot"], 0.5),
               "tpot_p90_ms": percentile(out["tpot"], 0.9)}
        print(json.dumps(row), flush=True)
        if grows:
            break
        knee = rate
    print(json.dumps({"knee": knee, "cell_rate": None if knee is None else 0.8 * knee}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
