"""One run of one cell: the context a driver works in, and the result
line made from what it returns.

A driver (``drivers/<kind>.py``) has ``run(ctx) -> dict`` with keys
``e2e`` (end-to-end values by metric name), ``attempted``, ``failed``,
``record`` (what the per-layer readers read), ``checks`` (the numbers
compared, by name) and ``memory_peak_bytes``.  It calls
:meth:`Context.window_opens` when set-up ends.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

from perfbench.harness.common import (forbidden_loaded, load_module, log,
                                      metrics_of)


@dataclass
class Context:
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # host clock at process start
    model: dict = field(init=False)
    setup_s: float | None = None
    params: dict | None = None
    config: object = None
    by_rid: dict = field(default_factory=dict)
    stretch: object = None
    engine_trace: object = None

    def __post_init__(self):
        self.model = self.cell["model"]
        self.cuda = self.device.type == "cuda"
        from perfbench.harness.port import Marks

        self.marks = Marks(self.cuda)
        if self.trace:
            from perfbench.harness.trace import Stretch

            self.stretch = Stretch(self.cuda)

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def empty_cache(self) -> None:
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()

    def window_opens(self) -> None:
        if self.stretch is not None:
            self.stretch.prime()
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch

        self.sync()
        return int(torch.cuda.max_memory_allocated())


def device_info(ctx: Context, peak: int, profile: dict | None) -> dict:
    import torch

    d = {"platform": "gpu" if ctx.cuda else "cpu",
         "kind": torch.cuda.get_device_name(0) if ctx.cuda else "cpu",
         "count": 1, "memory_peak_bytes": peak}
    if profile is not None:
        d["busy_s"] = profile["busy_s"]
        d["window_s"] = profile["window_s"]
    return d


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Every number compared against its limit (value <= limit); a number
    with no limit, or not a finite number, fails."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def execute(cell: dict, bench: dict, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> dict | None:
    """Run the cell once; the result object, or None when a forbidden module
    was loaded (named on standard error)."""
    ctx = Context(cell, seed, seconds, trace, device, t_start)
    driver = load_module("drivers", cell["driver"])
    out = driver.run(ctx)
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None
    e2e_defs, layer_defs = metrics_of(bench, cell["name"])
    profile = None
    if trace:
        profile = ctx.stretch.summary() if ctx.stretch.wall_s is not None else None
        rec = dict(out["record"], profile=profile, cell=cell, model=ctx.model)
        # the rates of a share of the peak hold at the card's full power limit
        log({"power_limit_w": power_limit()})
        metrics = {}
        for m in layer_defs:
            value = load_module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e_defs}
    correct, checks = judge(out["checks"], cell.get("limits", {}))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": device_info(ctx, out["memory_peak_bytes"], profile)}
    if profile is not None:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    return result


def power_limit() -> float | None:
    """The card's power limit in watts, from nvidia-smi; None without one."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None
