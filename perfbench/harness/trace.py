"""A ``torch.profiler`` stretch inside a traced window, reduced to what the
per-layer readers and the result's ``breakdown`` need: device time by kernel
name, the time the device was busy (the union of its operations' intervals),
and the idle gaps between them, each named by what the host was doing.

The stretch's length is taken on the host clock between two synchronising
reads, with the profiler's own overhead inside it, so the idle share it
gives is an upper bound (as ``chip_smoke.device_profile``'s).
"""

from __future__ import annotations

import contextlib
import time

# The benchmark's own host ranges, as the profiler records them.
RANGE_PREFIX = "bench."


@contextlib.contextmanager
def host_range(name: str, on: bool):
    """A ``record_function`` range named ``bench.<name>`` when ``on``."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(RANGE_PREFIX + name):
        yield


class Stretch:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.wall_s = None

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def prime(self) -> None:
        """Start and stop one empty profile, so that the start inside the
        window does not pay the profiler's first initialisation."""
        self.start()
        self._sync()
        self.prof.__exit__(None, None, None)
        self.prof = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.wall_s is None

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def events(self) -> tuple[list, list]:
        """(device operations, host ranges) as (name, start_ns, end_ns)."""
        from torch.autograd import DeviceType

        dev, host = [], []
        try:
            raw = self.prof.profiler.kineto_results.events()
            rows = ((e.name(), e.device_type(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in raw)
        except AttributeError:
            rows = ((e.name, e.device_type, int(e.time_range.start * 1e3),
                     int(e.time_range.end * 1e3)) for e in self.prof.events())
        for name, kind, a, b in rows:
            if kind == DeviceType.CUDA:
                # the benchmark's own ranges also appear on the device's
                # timeline, as annotations: they are not device work
                if not name.startswith(RANGE_PREFIX):
                    dev.append((name, a, b))
            elif kind == DeviceType.CPU:
                host.append((name, a, b))
        return dev, host

    def summary(self, top: int = 10) -> dict:
        """``busy_s``, ``window_s``, ``kernels`` {name: [count, seconds]},
        and the breakdown's ``device_ops`` and ``idle_gaps``."""
        dev, host = self.events()
        kernels: dict = {}
        for name, a, b in dev:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-9
        merged = []
        for _, a, b in sorted(dev, key=lambda r: r[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) * 1e-9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                       for i in range(len(merged) - 1)), reverse=True)[:top]
        ranges = sorted(host, key=lambda r: r[1])
        return {
            "busy_s": busy, "window_s": self.wall_s, "kernels": kernels,
            "device_ops": [[n, s] for n, (c, s) in sorted(
                kernels.items(), key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[_doing(ranges, at), g * 1e-9] for g, at in gaps],
        }


def _doing(ranges: list, at: int) -> str:
    """What the host was doing at ``at``: the innermost of the benchmark's
    ranges around it, else the innermost host operation, else "host"."""
    best, best_len, mine = "host", None, None
    for name, a, b in ranges:
        if a > at:
            break
        if b < at:
            continue
        if name.startswith(RANGE_PREFIX):
            if mine is None or b - a < mine[1]:
                mine = (name, b - a)
        elif best_len is None or b - a < best_len:
            best, best_len = name, b - a
    return mine[0] if mine is not None else best
