"""Read a DeepSeek-V3 serving cell on the chip with the program's expert
choices replayed into the reference (``perfbench/harness/deepseek.py``): the
float8 control, and the program with a named fault planted in it.

    python3 perfbench/control_deepseek.py --workload deepseekv3.longdoc \
        --seeds 1,2,3 [--fault <name>] [--seconds 20]

For each seed, one run of the cell's driver (``serve_backlog_routed``) in
this process: the seed's weights and traffic, set-up, the window, and over
the sample a run would compare the program's ``served_gap`` and
``route_gap``; without a fault also the control's ``control_gap``, how far
below the reference's best lies the token the reference in float8 puts first
at the same positions and choices.  The faults (:data:`FAULTS`), planted in
the program before its captures:

- ``no_mscale``: YaRN's mscale^2 left out of the softmax scale;
- ``unroped_k``: the cache's k_pe written without its rotation;
- ``no_kv_norm``: the cache's c_kv written without ``kv_a_norm``;
- ``no_bias``: the router's bias left out of the choice;
- ``no_group_limit``: the top k chosen over all experts, not inside the best
  groups;
- ``unscaled``: the gates not scaled by ``routed_scaling_factor``;
- ``no_shared``: the shared expert dropped.

One JSON line a seed.  Nothing here runs in the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness.common import load_module, log, set_environment, workload  # noqa: E402

FAULTS = ("no_mscale", "unroped_k", "no_kv_norm", "no_bias", "no_group_limit",
          "unscaled", "no_shared")


def plant(fault: str) -> None:
    """The fault in the program (``tputopo_torch.mla`` and ``.moe``)."""
    import torch

    from tputopo_torch import mla, moe

    if fault == "no_mscale":
        mla.softmax_scale = lambda m: (m.nope + m.rope) ** -0.5
    elif fault in ("unroped_k", "no_kv_norm"):
        def latent_row(h, layer, config, cos, sin):
            m = config.mla
            c, k_pe = mla.qdot(h, layer["kv_a"]).split([m.kv_rank, m.rope], dim=-1)
            if fault == "no_kv_norm":
                return torch.cat([c, mla.rope_pairs(k_pe[:, :, None], cos, sin)[:, :, 0]], -1)
            return torch.cat([mla._rmsnorm(c, layer["kv_a_norm"], config.norm_eps), k_pe], -1)

        mla.latent_row = latent_row
    elif fault in ("no_bias", "no_group_limit", "unscaled"):
        sound = moe._sigmoid_gates

        def gates(x32, router, bias, m):
            if fault == "no_bias":
                return sound(x32, router, torch.zeros_like(bias), m)
            if fault == "no_group_limit":
                return sound(x32, router, bias, dataclasses.replace(m, n_group=1, topk_group=1))
            g, idx = sound(x32, router, bias, m)
            return g / m.routed_scale, idx

        moe._sigmoid_gates = gates
    elif fault == "no_shared":
        moe._shared_expert = lambda x, p, dot=None: torch.zeros_like(x)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args(argv)
    set_environment()
    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    from perfbench.harness.core import Context

    if args.fault:
        plant(args.fault)
    cell = workload(args.workload)
    driver = load_module("drivers", cell["driver"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell, seed, args.seconds, False, device, T_START)
        out, _, peak, kept = driver.serve(ctx)
        read = driver.check(ctx, out, kept, control=not args.fault)
        print(json.dumps({"seed": seed, "fault": args.fault, "peak_bytes": peak,
                          "generated": out["generated"], **read}), flush=True)
        ctx.params = None
        ctx.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
