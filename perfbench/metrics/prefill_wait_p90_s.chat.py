"""p90 (nearest rank) of a request's wait from its first admission program to its first token reaching the host, over the requests admitted in the window."""

from perfbench.harness import program


def read(rec):
    return program.waits_p90(rec, 'admitted', 'first_token')
