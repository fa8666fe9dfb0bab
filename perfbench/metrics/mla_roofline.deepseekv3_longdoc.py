"""Latent attention's least time over its measured device time, in the
profiled stretch: the least time of the work the program's ``mla`` counts
(their growth between the stretch's start and stop) describe, the smaller of
the absorbed and the expanded forms' flops at the bf16 peak against the
live latent rows, q and the output at HBM bandwidth
(:mod:`perfbench.harness.latent`), over the growth of ``mla.device_ns``.
The counting lives here, so the share reads the same work whatever
implements it.  None where the program keeps no such counter."""

from perfbench.harness.latent import least_s, stretch_delta


def read(rec):
    d = stretch_delta(rec, "mla")
    if not d or not d.get("device_ns"):
        return None
    return 100.0 * least_s(rec["model"], d) / (d["device_ns"] * 1e-9)
