"""Device ms per decode step: the program's CUDA events tight around each decode program's graph replay, summed, over the steps those replays ran."""

from perfbench.harness import program


def read(rec):
    return program.replay_decode_ms(rec)
