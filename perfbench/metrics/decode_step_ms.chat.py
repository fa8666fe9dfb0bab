"""Device ms per decode step: CUDA events around each ``decode_step(s)``
program call of the engine, summed, over the steps those calls ran."""

from perfbench.harness.readers import decode_ms_per_step


def read(rec):
    return decode_ms_per_step(rec)
