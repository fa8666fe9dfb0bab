"""Latent attention's share of the device's busy time over the profiled
stretch: the program's ``mla.device_ns`` (the GPU's global timer read on the
device where each call starts, the queries' absorption or the rows'
up-projection, and where it ends, the values' projection; both forms), its
growth between the stretch's start and stop, over the union of the device
operations' intervals in the same stretch.  None where the program keeps
no such counter."""

from perfbench.harness.latent import stretch_delta


def read(rec):
    prof = rec.get("profile")
    d = stretch_delta(rec, "mla")
    if not prof or not prof.get("busy_s") or not d or not d.get("device_ns"):
        return None
    return 100.0 * d["device_ns"] * 1e-9 / prof["busy_s"]
