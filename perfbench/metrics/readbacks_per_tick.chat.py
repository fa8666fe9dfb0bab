"""Device-to-host reads of the engine a tick, counted by the program's tracer over the window."""

from perfbench.harness import program


def read(rec):
    return program.per_tick(rec, lambda pt: pt['counters'].get('readbacks', 0))
