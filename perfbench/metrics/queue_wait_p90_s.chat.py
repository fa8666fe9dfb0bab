"""p90 (nearest rank) of a request's wait in the queue, from submit to its first admission program, over the requests the program's tracer saw admitted in the window."""

from perfbench.harness import program


def read(rec):
    return program.waits_p90(rec, 'queued', 'admitted')
