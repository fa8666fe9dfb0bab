"""What every run shares: where the benchmark's files are, how a name finds
its file, the cache directories, the seeds, percentiles, the import guard and
the result line.

Nothing here imports the program or torch at import time: the environment
(cache directories, thread counts) must be set before torch loads.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent      # perfbench/
ROOT = BENCH.parent                                  # the checkout
CACHE = BENCH / ".cache"                             # fixed, inside the checkout

# Top-level module names that may never be loaded in a run's process: the
# JAX stack and the JAX package the program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tputopo")


def set_environment() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so the
    second run of a cell finds what the first one built; few host threads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    """A cell's file, ``workloads/<name>.json``, with its traffic mix
    (``traffic/<traffic>.json``) and configuration (``configs/<config>.json``)
    attached under ``traffic_mix`` and ``model``."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["traffic_mix"] = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    cell["model"] = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module: a driver, or a per-layer
    metric's reader (its name may hold dots, so it is loaded by path)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric without ``workloads`` is reported wherever the metric it moves
    is."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose of a run (weights, traffic, a batch),
    from the run's seed, which may exceed 32 bits."""
    import numpy as np

    ss = np.random.SeedSequence([abs(int(seed)), *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def percentile(values, q: float) -> float | None:
    """The nearest-rank percentile: the smallest value with at least
    ``q`` of the sample at or below it (``q`` in (0, 1])."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def log(obj) -> None:
    """One line on standard error: a JSON object, or text."""
    print(obj if isinstance(obj, str) else json.dumps(obj), file=sys.stderr,
          flush=True)
