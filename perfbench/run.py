"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end ones; with
``--trace 1`` its per-layer ones, read from the benchmark's spans and a
profiler stretch at the end of the window.  The numbers compared to decide
``correct`` are printed, each beside its limit, as the last lines of
standard error and under the result's last key, ``checks``.

It needs as many CUDA devices as the cell asks for, and exits non-zero with
no result without them: there is no CPU fallback.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.harness.common import (benchmark, log, set_environment,  # noqa: E402
                                      workload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = workload(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"needs {entry['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    from perfbench.harness.core import execute

    result = execute(cell, bench, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
