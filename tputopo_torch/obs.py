"""Spans and counters inside the port: where a serving tick's host time
goes, when the device waits on the host, and how a training step's device
time splits.

A :class:`Tracer` is handed to what it observes (``ServingEngine(...,
tracer=)``, ``make_sharded_train_step(..., tracer=)``); without one every
site is a single ``is None`` test, so an untraced run reads no clock,
makes no CUDA event and grows no list.  It records, in memory up to a
fixed capacity, and writes out only when :meth:`Tracer.export` is called:

- **host spans** (``perf_counter_ns``): a name, a start and an end, an id
  and the id of the span open around it (its cause), a request id where
  the work is one request's, and a few attributes (slot, prompt tokens,
  first position, steps);
- **device spans**: a pair of timing CUDA events on the current stream
  (external ones inside a graph capture, so that they become event-record
  nodes of the graph and every replay records them again), or the host
  clock on the CPU.  Their times are read only in :meth:`Tracer.export`,
  after the caller has synchronised;
- **counters**: plain integers (``readbacks`` and ``readbacks.<phase>``);
- **request life**: ``queued``, ``admitted``, ``first_token`` and
  ``finished`` per request id, the first occurrence of each kept;
- **stalls**: from a device-to-host read's return (the stream is empty
  then) to the next program launch, the device has nothing queued.  The
  hot path stores the two times; :meth:`Tracer.export` splits each stall
  over the serving tick's phase spans it overlaps.

Wall time is telemetry here, never an input to the program: a traced run
computes what an untraced one does.  The tracer opens no
``torch.profiler.record_function`` range (a profiler would count it as
device work) and prints nothing.  :meth:`Tracer.export` gives every host
span on the epoch clock as well, which is the clock a ``torch.profiler``
trace's events carry: two anchors, (``perf_counter_ns``, ``time_ns``) at
the start and at the export, interpolate between the two clocks.

The design follows the reference's flight recorder
(``tputopo/obs/tracer.py``): absent when off, spans with counters, wall
time kept apart from what the program decides.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

# Spans kept before further ones are only counted: a 45 s window of a chat
# engine at ten ticks a second records ~10 host spans and ~2 device spans
# a tick (~4,300 and ~800), so this holds such a window fifteen times over.
CAPACITY = 1 << 16

# The phases of a serving tick (``ServingEngine.step``), in order.
PHASES = ("harvest", "prefill", "admit", "decode", "stream")

# Where a readback or a stall outside every tick is put down.
CALLER = "caller"


class _Span:
    """An open host span; closing it stores it in its tracer."""

    __slots__ = ("tracer", "sid", "parent", "name", "start", "rid", "attrs")

    def __init__(self, tracer, name, rid, attrs):
        self.tracer, self.name, self.rid, self.attrs = tracer, name, rid, attrs

    def __enter__(self):
        tr = self.tracer
        self.sid = tr._new_id()
        self.parent = tr._parent()
        tr._stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self.tracer
        tr._stack.pop()
        tr._keep(tr._spans, (self.sid, self.parent, self.name, self.start, end,
                             self.rid, self.attrs))
        return False


class Tracer:
    """The spans, counters and request events of one traced run (see the
    module's docstring).  :data:`CAPACITY` bounds the host spans, the
    device spans and the stalls kept, each; what lies beyond is counted in
    ``dropped``."""

    def __init__(self) -> None:
        self.capacity = CAPACITY
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.counters: collections.Counter = collections.Counter()
        self.dropped = 0
        self._ids = 0
        self._stack: list[_Span] = []
        self._spans: list[tuple] = []       # (id, parent, name, start, end, rid, attrs)
        self._device: list[tuple] = []      # (id, parent, name, start mark, end mark, attrs)
        self._stalls: list[tuple] = []      # (readback returned, next launch)
        self._stall_from: int | None = None
        self._requests: dict[int, dict[str, int]] = {}
        self._lap: tuple | None = None      # (group, last mark) of the open lap group
        self._groups = 0
        self._carried: dict = {}

    # -- recording --

    def _new_id(self) -> int:
        self._ids += 1
        return self._ids

    def _keep(self, where: list, item: tuple) -> None:
        if len(where) < self.capacity:
            where.append(item)
        else:
            self.dropped += 1

    def _parent(self) -> int | None:
        return self._stack[-1].sid if self._stack else None

    def span(self, name: str, rid: int | None = None, **attrs) -> _Span:
        """A host span as a context manager, child of the span open
        around it."""
        return _Span(self, name, rid, attrs)

    def interval(self, name: str, start: int, end: int, **attrs) -> None:
        """A host span whose two times the caller took (``perf_counter_ns``),
        child of the span open around it."""
        self._keep(self._spans, (self._new_id(), self._parent(), name, start, end,
                                 None, attrs))

    def mark(self, device) -> object:
        """A device mark on ``device``'s current stream: a timing CUDA
        event (an external one while a graph capture records, so that
        every replay records it again), or the host clock on the CPU."""
        if torch.device(device).type != "cuda":
            return time.perf_counter_ns()
        ev = torch.cuda.Event(enable_timing=True,
                              external=torch.cuda.is_current_stream_capturing())
        ev.record()
        return ev

    def device_span(self, name: str, start, end, **attrs) -> None:
        """A device span between two :meth:`mark` s, child of the host span
        open around it."""
        self._keep(self._device, (self._new_id(), self._parent(), name, start, end,
                                  attrs))

    def lap_group(self, device) -> None:
        """Open a group of contiguous device spans at a mark on ``device``
        (a training step's), which :meth:`lap` continues."""
        self._groups += 1
        self._lap = (self._groups, self.mark(device))

    def lap(self, name: str, device) -> None:
        """The device span ``name`` from the open group's previous mark to
        a new one."""
        mark = self.mark(device)
        self.device_span(name, self._lap[1], mark, group=self._lap[0])
        self._lap = (self._lap[0], mark)

    def readback(self) -> None:
        """A device-to-host read has returned: counted in ``readbacks``
        and under ``readbacks.<the innermost open span>`` (``caller``
        outside every span); the device has nothing queued from now until
        the next :meth:`launched`."""
        now = time.perf_counter_ns()
        self.counters["readbacks"] += 1
        self.counters["readbacks." + (self._stack[-1].name if self._stack else CALLER)] += 1
        if self._stall_from is None:
            self._stall_from = now

    def launched(self) -> None:
        """A program is being launched: the stall open since a readback,
        if any, ends now."""
        if self._stall_from is not None:
            self._keep(self._stalls, (self._stall_from, time.perf_counter_ns()))
            self._stall_from = None

    def request(self, rid: int, event: str) -> None:
        """``event`` of request ``rid`` happens now; a repeat of an event
        keeps the first time."""
        self._requests.setdefault(rid, {}).setdefault(event, time.perf_counter_ns())

    def carry(self, name: str, snapshot) -> None:
        """Export ``snapshot()`` (a dict of counts an owner keeps, such as
        an engine's ``metrics``) under ``name`` beside the tracer's own."""
        self._carried[name] = snapshot

    # -- export --

    def export(self) -> dict:
        """Everything recorded, as plain data.  Call after the device work
        has been synchronised: device spans are read here.  A device span
        whose events never ran (a graph captured and not yet replayed)
        reads None.  Times are ``perf_counter_ns`` (``start``, ``end``) and
        the epoch clock (``epoch_start``, ``epoch_end``, ns); device spans
        give milliseconds.  A graph's device spans hold its last replay."""
        end_anchor = (time.perf_counter_ns(), time.time_ns())
        epoch = _epoch(self.anchor, end_anchor)
        spans = [{"id": sid, "parent": parent, "name": name, "start": s, "end": e,
                  "epoch_start": epoch(s), "epoch_end": epoch(e),
                  **({} if rid is None else {"rid": rid}), **attrs}
                 for sid, parent, name, s, e, rid, attrs in self._spans]
        device = [{"id": sid, "parent": parent, "name": name, "ms": _elapsed_ms(a, b),
                   **attrs} for sid, parent, name, a, b, attrs in self._device]
        out = {"anchors": {"start": list(self.anchor), "end": list(end_anchor)},
               "capacity": self.capacity, "dropped": self.dropped,
               "counters": dict(self.counters),
               "ticks": sum(1 for s in self._spans if s[2] == "tick"),
               "stall": self._split_stalls(),
               "requests": {rid: dict(ev) for rid, ev in self._requests.items()},
               "laps": _last_laps(device),
               "spans": spans, "device": device}
        for name, snapshot in self._carried.items():
            out[name] = snapshot()
        return out

    def _split_stalls(self) -> dict:
        """Each stall's milliseconds split over the tick phases it overlaps:
        a phase span's own name, ``tick`` for the rest of a tick, and
        ``caller`` outside every tick."""
        ticks = sorted((s[3], s[4], s[0]) for s in self._spans if s[2] == "tick")
        tick_ids = {sid for _, _, sid in ticks}
        phases = sorted((s[3], s[4], s[2]) for s in self._spans
                        if s[1] in tick_ids and s[2] in PHASES)
        by = collections.Counter()
        total = 0
        for s, e in self._stalls:
            total += e - s
            inside = _overlap(ticks, s, e, by, None)
            in_phases = _overlap(phases, s, e, by, True)
            by["tick"] += inside - in_phases
            by[CALLER] += (e - s) - inside
        return {"ms": total / 1e6, "intervals": len(self._stalls),
                "by_phase": {k: v / 1e6 for k, v in by.items() if v}}


class LatentCounts:
    """A tracer's counts of latent attention (:func:`~.attention.cached_latent_attention`),
    held on the device as int64 running sums and added to inside the
    captured programs (no readback), apart for the absorbed form (decode,
    ``decode_*``) and the expanded one (prefill, ``prefill_*``): ``calls``
    (one a layer a program call), ``queries`` (query tokens), ``rows`` (the
    latent rows the queries attend, each row's positions up to its last
    query), ``pairs`` (query x attended position pairs), and on CUDA ``ns``,
    the device time from the GPU's global timer where the call starts (the
    queries' absorption, or the rows' up-projection) and where it ends (the
    values' projection).  A decode step's idle slots, whose junk window
    sits at the buffer's last position, count in none of them but
    ``calls``.  :meth:`snapshot` reads them back with the sums ``calls`` and
    ``device_ns``."""

    FIELDS = ("calls", "queries", "rows", "pairs", "ns")
    NAMES = ("decode_calls", "decode_queries", "decode_rows", "decode_pairs", "decode_ns",
             "prefill_calls", "prefill_queries", "prefill_rows", "prefill_pairs",
             "prefill_ns")

    def __init__(self, device) -> None:
        self.values = torch.zeros(len(self.NAMES), dtype=torch.int64, device=device)

    def _base(self, absorbed: bool) -> int:
        return 0 if absorbed else len(self.FIELDS)

    def add(self, absorbed: bool, pos: torch.Tensor, T: int, S: int) -> None:
        """One call of T queries a row at positions pos[b] + t over a cache
        of S positions."""
        live = (pos + T < S).long()
        one = torch.ones((), dtype=torch.int64, device=pos.device)
        rows = (pos + T) * live
        pairs = (T * (pos + 1) + T * (T - 1) // 2) * live
        base = self._base(absorbed)
        self.values[base:base + 4] += torch.stack((one, live.sum() * T, rows.sum(),
                                                   pairs.sum()))

    def clock(self, absorbed: bool, sign: int) -> None:
        """Add ``sign`` x the GPU's global timer to the form's ``ns``;
        nothing off CUDA."""
        if self.values.device.type == "cuda":
            from tputopo_torch import _kernels, attention

            i = self._base(absorbed) + 4
            attention._call(_kernels.DEVICE_CLOCK, (self.values[i:].data_ptr(), sign, 0.0),
                            self.values.device, "device clock")

    def snapshot(self) -> dict:
        d = dict(zip(self.NAMES, self.values.tolist()))
        d["calls"] = d["decode_calls"] + d["prefill_calls"]
        d["device_ns"] = d["decode_ns"] + d["prefill_ns"]
        return d


def _overlap(intervals: list, s: int, e: int, by: collections.Counter,
             named: bool | None) -> int:
    """The ns of [s, e) covered by the sorted, disjoint ``intervals``
    (start, end, name); with ``named``, each part is added to ``by`` under
    its interval's name."""
    got = 0
    i = bisect.bisect_left(intervals, (e,)) - 1
    while i >= 0 and intervals[i][1] > s:
        a, b, name = intervals[i]
        part = max(0, min(b, e) - max(a, s))
        got += part
        if named:
            by[name] += part
        i -= 1
    return got


def _epoch(a: tuple, b: tuple):
    """perf_counter_ns -> time_ns, linear between the anchors ``a`` and
    ``b`` (each (perf, epoch))."""
    span_perf = b[0] - a[0]
    rate = (b[1] - a[1]) / span_perf if span_perf > 0 else 1.0
    return lambda t: a[1] + round((t - a[0]) * rate)


def _elapsed_ms(a, b) -> float | None:
    if isinstance(a, int):
        return (b - a) / 1e6
    try:
        return a.elapsed_time(b)
    except RuntimeError:  # an event that never ran
        return None


def _last_laps(device: list) -> dict:
    """The milliseconds of each lap name, summed, in the last lap group
    recorded: under replay the captured group, whose events the latest
    replay recorded.  Empty when that group reads None in part (captured
    and not yet replayed): an earlier group is never put in its place."""
    last = max((d["group"] for d in device if "group" in d), default=None)
    group = [d for d in device if d.get("group") == last] if last is not None else []
    if not group or any(d["ms"] is None for d in group):
        return {}
    out: dict = {}
    for d in group:
        out[d["name"]] = out.get(d["name"], 0.0) + d["ms"]
    return out
