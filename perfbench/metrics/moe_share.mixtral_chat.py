"""The routed expert layer's share of the device's busy time over the
profiled stretch: the layer's device time (the program's ``moe.device_ns``,
the GPU's global timer read on the device at the layer's start and end in
every call, routing, sort, gather, the expert tables' casts, the grouped
GEMMs and the combine included) over the stretch, taken as the difference
of the counter's snapshots at the stretch's start and stop, over the
union of the device operations' intervals in the same stretch.  None
where the program keeps no such counter."""


def stretch_delta(rec, group: str, name: str):
    """A counter's growth over the profiled stretch, or None."""
    marks = rec.get("stretch_counts") or {}
    a = (marks.get("start") or {}).get(group) or {}
    b = (marks.get("stop") or {}).get(group) or {}
    if name not in a or name not in b:
        return None
    return b[name] - a[name]


def read(rec):
    prof = rec.get("profile")
    ns = stretch_delta(rec, "moe", "device_ns")
    if not prof or not prof.get("busy_s") or not ns:
        return None
    return 100.0 * ns * 1e-9 / prof["busy_s"]
