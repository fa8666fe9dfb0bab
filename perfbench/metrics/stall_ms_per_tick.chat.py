"""Host ms a tick during which the device had nothing queued: from each engine readback's return to the next program launch (the program's tracer), summed over the window, over its ticks."""

from perfbench.harness import program


def read(rec):
    return program.per_tick(rec, lambda pt: pt['stall']['ms'])
