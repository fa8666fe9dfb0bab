"""Share of the profiled stretch at the window's end in which no operation
ran on the device; an upper bound (the stretch holds the profiler's own
overhead)."""

from perfbench.harness.readers import idle_percent


def read(rec):
    return idle_percent(rec)
