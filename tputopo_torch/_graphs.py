"""Capture and replay of the port's compiled programs as CUDA graphs.

The reference compiles its serving path with ``jax.jit``: the engine's
device work is a handful of programs (``admit_jit``, ``decode_steps_jit``,
...), each traced once per set of static arguments and then dispatched as
one unit.  Their counterparts here are ``torch.cuda.CUDAGraph`` captures
(not ``torch.jit``): a program's eager body is recorded once on static
buffers and replayed, so the device runs the same kernels in the same
order as the eager body would, with one host call per program in place of
thousands of ATen dispatches.

A :class:`Programs` owns the captured graphs of one caller (a serving
engine, or the module-level default of the ``*_jit`` functions), one
graph memory pool that they share (they replay one at a time on one
stream) and the counts: captures and replays per program, and the seconds
spent capturing.  A capture is keyed on everything the recorded graph
bakes in:

- the program's name and its static arguments (the reference's
  ``static_argnames``: the config, ``n``, ``temperature``, ``top_k`` ...);
- the shape and dtype of each INPUT, a tensor whose values change from
  call to call: it is copied into the graph's own static buffer before
  each replay;
- the ``data_ptr``, shape, strides and dtype of every tensor of the BOUND
  trees (parameters, decode state, caches), which the graph reads and
  writes where they lie, and the value of every non-tensor leaf (a LoRA
  scale): a new params tree or a new state recaptures, and a replay never
  reads a stale pointer;
- the device and the sampling generator, if any;
- what a body reads beyond its arguments and bound trees (:data:`AMBIENT`:
  the expert layer's counts while a tracer counts), so that a program
  captured without them is not replayed where they are read, nor the
  reverse.

An engine's programs keep every graph they capture: its bound trees live
as long as it does.  The process-wide default of the ``*_jit`` calls that
name no owner keeps one graph per program, static arguments, input shapes
and device: a call on other bound storage (a reloaded params tree)
replaces that graph, so a process holds one graph, and one set of pool
outputs, per shape and not one per tree it ever passed.

Before its capture a program runs once eagerly on a side stream (cuBLAS
handles and workspaces, a kernel library's first load, NCCL's
communicator, which starts at its first collective), with the tensors it
mutates and the generator's state put back afterwards.  The capture
records; the replay that follows does the call's work.  A DONATED program
(the reference's ``donate_argnums``: a training step over its state)
keeps what its warm-up did instead: that run is the first call's work,
its outputs the first call's result, and nothing is cloned or restored
(a training state at Llama-3-8B width is ~31 GB, which the card cannot
hold twice).  Its capture follows, after the warm-up's freed memory has
gone back to the device, and executes nothing; later calls replay.

Which programs replay is decided before the call, from the device and the
process groups a program's collectives run over (:func:`replays`): on
CUDA, when every group is NCCL's.  Gloo stages CUDA tensors through host
memory, which a capture cannot record, so under gloo, as on the CPU
(which only a caller who asks for it gets), a program runs its body
eagerly.  Nothing falls back: on CUDA a capture or replay that fails
raises.

A kernel wrapper counts a launch it makes eagerly; while a capture records
it counts nothing there, and each replay adds the launches its capture
recorded (``Kernel.launches``), so a count is the number of times the
kernel ran on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from tputopo_torch import _kernels


# Callables returning what the bodies read besides their arguments and
# bound trees (a tree of tensors, or None); its signature joins every
# capture's key.  A module whose body code reads such state registers here.
AMBIENT: list[Callable[[], object]] = []


def capturing(device) -> bool:
    """Whether a CUDA graph capture is recording on the current stream of
    ``device`` (never on the CPU: the CPU build has no capture)."""
    return torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing()


def graphed(device) -> bool:
    """Whether the programs of ``device`` replay captured graphs: on CUDA;
    on the CPU they run their bodies eagerly."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"compiled programs run on cuda or cpu, not {device}")
    return kind == "cuda"


def replays(device, groups=()) -> bool:
    """Whether a program of ``device`` whose collectives run over the
    process ``groups`` replays a captured graph: where :func:`graphed` and
    every group is NCCL's.  Under gloo its body runs eagerly."""
    return graphed(device) and all(dist.get_backend(g) == "nccl" for g in groups)


def _fields(tree) -> tuple | None:
    """A dataclass instance's field values (a TrainState, an AdamState),
    else None."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(getattr(tree, f.name) for f in dataclasses.fields(tree))
    return None


def tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict / tuple / NamedTuple / dataclass, in
    order."""
    if torch.is_tensor(tree):
        return [tree]
    if _fields(tree) is not None:
        return tensors(_fields(tree))
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors(v)]
    return []


def signature(tree):
    """What a capture bakes in of a bound tree: each tensor's pointer,
    shape, strides, dtype and device; each other leaf's value."""
    if torch.is_tensor(tree):
        return (tree.data_ptr(), tuple(tree.shape), tree.stride(), tree.dtype, tree.device)
    if _fields(tree) is not None:
        return signature(_fields(tree))
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return tuple(signature(v) for v in tree)
    return tree


class _Entry(NamedTuple):
    bound: tuple            # the signature of the bound trees it reads
    graph: torch.cuda.CUDAGraph
    inputs: tuple           # the static input buffers
    outputs: object         # what the captured body returned (pool tensors)
    launches: dict          # Kernel -> launches recorded by the capture
    generator: object       # held, so its id in the key stays its own


class Programs:
    """The captured programs of one owner: graphs by key, one shared graph
    memory pool, and counts (``captures`` and ``replays`` per program
    name, ``capture_seconds``; the kernels' ``launches``).  With
    ``latest_only``, one graph per key less the bound trees' signature:
    other bound storage replaces it."""

    def __init__(self, latest_only: bool = False) -> None:
        self.latest_only = latest_only
        self._graphs: dict = {}
        self.pool = None
        self.captures: collections.Counter = collections.Counter()
        self.replays: collections.Counter = collections.Counter()
        # Kernel name -> launches its replays ran (``Kernel.launches`` counts
        # them process-wide).
        self.launches: collections.Counter = collections.Counter()
        self.capture_seconds = 0.0
        # The owner's :class:`~.obs.Tracer`, or None: each call then records
        # a host span ``dispatch`` (entry to the launch) and a device span
        # ``replay`` tight around the launch (``call``: replay, capture or
        # eager); ``capture_seconds`` times the captures.
        self.tracer = None

    def counts(self) -> dict:
        """The counters as plain data."""
        return {"captures": dict(self.captures), "replays": dict(self.replays),
                "capture_seconds": self.capture_seconds}

    def release(self) -> None:
        """Drop every graph; their pool's memory goes back to the
        allocator once nothing else holds it."""
        self._graphs.clear()
        self.pool = None

    def run(self, name: str, body: Callable, *, device, static: tuple,
            inputs: tuple = (), bound=None, mutated=None, donate: bool = False,
            groups=(), generator: torch.Generator | None = None):
        """``body(*inputs)`` as the program ``name``: on CUDA, the replay of
        its graph for this key (captured on the first call), which returns
        the captured outputs (static pool tensors, overwritten by the next
        replay); on the CPU or under gloo (:func:`replays` of ``device`` and
        the process ``groups`` its collectives use), the body run eagerly.
        ``mutated`` is the part of ``bound`` that the body writes; with
        ``donate`` the call that captures returns its warm-up's outputs,
        the warm-up having done its work on ``mutated`` for good."""
        tr = self.tracer
        t_in = None if tr is None else time.perf_counter_ns()
        if not replays(device, groups):
            if tr is None:
                return body(*inputs)
            return _launch(tr, t_in, device, "eager", body, *inputs)
        device = torch.device(device)
        bound_sig = signature(bound)
        key = (name, static, device,
               tuple((tuple(t.shape), t.dtype) for t in inputs),
               None if generator is None else id(generator),
               tuple(signature(read()) for read in AMBIENT))
        if not self.latest_only:
            key += (bound_sig,)
        entry = self._graphs.get(key)
        if entry is not None and entry.bound != bound_sig:
            del self._graphs[key], entry  # free its outputs before the capture
            entry = None
        if entry is None and tr is not None:  # the capture's warm-up launches
            tr.interval("dispatch", t_in, time.perf_counter_ns())
            tr.launched()
            t_in = None
        if entry is None and donate:
            entry, first = self._capture_donated(name, body, device, inputs, generator,
                                                 bound_sig)
            self._graphs[key] = entry
            return first
        if entry is None:
            entry = self._capture(name, body, device, inputs, mutated, generator,
                                  bound_sig)
            self._graphs[key] = entry
            call = "capture"
        else:
            for buf, t in zip(entry.inputs, inputs):
                buf.copy_(t)
            call = "replay"
        if tr is None:
            entry.graph.replay()
        else:
            _launch(tr, t_in, device, call, entry.graph.replay)
        self.replays[name] += 1
        for kernel, n in entry.launches.items():
            kernel.launches += n
            self.launches[kernel.name] += n
        return entry.outputs

    def _capture(self, name, body, device, inputs, mutated, generator,
                 bound_sig) -> _Entry:
        """A new graph's entry, after a warm-up whose writes to ``mutated``
        are undone."""
        return self._record(name, body, device, inputs, mutated, False, generator,
                            bound_sig)[0]

    def _capture_donated(self, name, body, device, inputs, generator,
                         bound_sig) -> tuple[_Entry, object]:
        """A donated program's new graph: its entry, and the outputs of the
        warm-up, which did the call's work."""
        return self._record(name, body, device, inputs, None, True, generator, bound_sig)

    def _record(self, name, body, device, inputs, mutated, donate, generator,
                bound_sig) -> tuple[_Entry, object]:
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            static_in = tuple(t.to(device, copy=True) for t in inputs)
            first = _warm_up(body, static_in, mutated, generator)
            if donate:  # the warm-up's activations go back before the pool grows
                torch.cuda.empty_cache()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            before = {k: k.captured for k in _kernels.COUNTED}
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = body(*static_in)
        launches = {k: k.captured - n for k, n in before.items() if k.captured != n}
        self.captures[name] += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Entry(bound_sig, graph, static_in, outputs, launches, generator), first


def _launch(tracer, t_in, device, call: str, fn, *args):
    """``fn(*args)``, a program's launch, traced: the host span
    ``dispatch`` from ``t_in`` (None: recorded already) to the launch, the
    stall open since a readback closed, and the device span ``replay``
    tight around it."""
    if t_in is not None:
        tracer.interval("dispatch", t_in, time.perf_counter_ns())
    tracer.launched()
    start = tracer.mark(device)
    out = fn(*args)
    tracer.device_span("replay", start, tracer.mark(device), call=call)
    return out


def _warm_up(body, inputs, mutated, generator):
    """One eager run of ``body`` on a side stream, as a capture needs
    before it records; the tensors of ``mutated`` and the generator's
    state are put back as they were.  Returns what the body returned."""
    saved = [t.clone() for t in tensors(mutated)]
    gen_state = None if generator is None else generator.get_state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = body(*inputs)
        for t, s in zip(tensors(mutated), saved):
            t.copy_(s)
    side.synchronize()
    if gen_state is not None:
        generator.set_state(gen_state)
    return out


# The programs of the ``*_jit`` calls that name no owner: one process-wide
# cache, as the reference's ``jax.jit`` keeps one, holding the latest graph
# of each shape.
_DEFAULT = Programs(latest_only=True)


def run(programs: Programs | None, name: str, body: Callable, **kw):
    """:meth:`Programs.run` on ``programs``, or on the process-wide default."""
    return (programs if programs is not None else _DEFAULT).run(name, body, **kw)
