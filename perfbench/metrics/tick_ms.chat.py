"""Mean host time of one engine tick (``ServingEngine.step``) over the
traced window: the benchmark's span around each call."""


def read(rec):
    ticks = rec.get("tick_ms") or []
    return sum(ticks) / len(ticks) if ticks else None
