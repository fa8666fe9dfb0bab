"""Device ms per 1000 prompt tokens admitted: CUDA events around each
``admit`` / ``prefill_chunk`` / ``admit_final_chunk`` program call, summed,
over the real prompt tokens those calls took in (bucket padding and chunk
tails not counted)."""

from perfbench.harness.readers import prefill_ms_per_ktok


def read(rec):
    return prefill_ms_per_ktok(rec)
