"""Device ms per 1000 real prompt tokens of the admission programs: the program's CUDA events tight around each admission program's graph replay, summed, over the prompt tokens those replays took in."""

from perfbench.harness import program


def read(rec):
    return program.replay_prefill_ms_per_ktok(rec)
