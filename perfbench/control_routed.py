"""Read an expert model's serving cell on the chip with the program's expert
choices replayed into the reference (``perfbench/harness/routed.py``): the
control, and the program with a fault planted in its routing.

    python3 perfbench/control_routed.py --workload mixtral.chat --seeds 1,2,3 \
        [--fault top1|unnormalised|bottom] [--seconds 30]

One process sets the engine up once, with the fault, if any, planted in the
program's routing before the captures: ``top1`` gives each token's first
expert the whole gate and the second none (top-1 routing, the ids kept),
``unnormalised`` leaves the top-k gates as the softmax gave them, not
renormalised over the k, ``bottom`` routes each token to its k least likely
experts (gates renormalised over them).  For each seed it draws that seed's
weights into the same storage (the captured programs stay valid), serves the seed's
traffic for the window, drains, and over the sample a run would compare
reads the program's ``served_gap`` and ``route_gap`` and, at the same
positions and choices, the control's ``control_gap``: how far below the
best lies the token the reference in float8 puts first.  Beside them, under
``free_routing``, the same numbers with the reference choosing its own
experts, as the dense cells' check reads them.

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


def plant(fault: str) -> None:
    """The fault in the program's routing (``tputopo_torch.moe``)."""
    import torch

    from tputopo_torch import moe

    if fault == "top1":
        sound = moe._top_k_gates

        def top1(x32, router, m):
            gates, idx = sound(x32, router, m)
            first = torch.zeros_like(gates)
            first[..., 0] = 1.0
            return first, idx

        moe._top_k_gates = top1
    elif fault == "unnormalised":
        def unnormalised(x32, router, m):
            return torch.topk(torch.softmax(x32 @ router.float(), dim=-1), m.top_k, dim=-1)

        moe._top_k_gates = unnormalised
    elif fault == "bottom":
        def bottom(x32, router, m):
            gates, idx = torch.topk(-torch.softmax(x32 @ router.float(), dim=-1), m.top_k,
                                    dim=-1)
            return gates / gates.sum(-1, keepdim=True), idx

        moe._top_k_gates = bottom
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--fault", choices=("top1", "unnormalised", "bottom"))
    args = ap.parse_args(argv)
    set_environment()
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    from perfbench.drivers.serve_open_traced import build
    from perfbench.harness import routed, serving, traffic
    from perfbench.harness.core import Context
    from perfbench.harness.port import model_config
    from perfbench.harness.weights import make

    if args.fault:
        plant(args.fault)
    cell = workload(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    ctx = Context(cell, seeds[0], args.seconds, False, device, T_START)
    ctx.config = model_config(ctx.model)
    ctx.params = make(ctx.model, ctx.seed, device)
    engine = build(ctx, record_routes=True)
    serving.warm(ctx, engine)
    for seed in seeds:
        ctx.seed = seed
        make(ctx.model, seed, device, into=ctx.params)
        reqs = traffic.requests(cell["traffic_mix"], seed, ctx.model["vocab_size"],
                                args.seconds)
        out = serving.run_window(ctx, engine, reqs)
        engine.run()
        sample = serving.choose(seed, out["done"], cell["check"])
        rid_of = {id(r): rid for rid, r in ctx.by_rid.items()}
        read = routed.gaps(ctx.params, ctx.model, sample, rid_of, routed.host_routes(engine),
                           device, control=not args.fault)
        # the same sample with the reference routing on its own, as the
        # dense cells are checked: what the replay takes away
        free = serving.gaps(ctx.params, ctx.model, sample, device, control=not args.fault)
        print(json.dumps({"seed": seed, "fault": args.fault, **read,
                          "free_routing": {k: v for k, v in free.items() if "gap" in k}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
