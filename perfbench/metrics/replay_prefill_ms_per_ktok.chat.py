"""Device ms per 1000 prompt tokens: the program's CUDA events tight around each admission program's graph replay, summed, over the real prompt tokens those calls took in."""

from perfbench.harness import program


def read(rec):
    return program.replay_prefill_ms_per_ktok(rec)
