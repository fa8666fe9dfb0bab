"""The port's tracer (tputopo_torch.obs) inside the serving engine and the
sharded train step, on the CPU at a tiny size: the shape of what it
records (a tick span with its five phases, program spans over their
dispatch and replay, every readback, each request's life, the stall split
by phase, the train step's forward / backward / optimizer laps), that a
traced run computes what an untraced one does (and the JAX engine), that
an untraced one reads no clock, that the program opens no profiler range,
and that the export's epoch clock lies on a profiler trace's."""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch.profiler import ProfilerActivity, profile, record_function

from tests.torch_parity import to_torch, world_of_one
from tputopo.workloads import model as jm
from tputopo.workloads import serving as js
from tputopo_torch import _graphs
from tputopo_torch import model as tm
from tputopo_torch import obs
from tputopo_torch import serving as ts
from tputopo_torch import sharding as sh
from tputopo_torch import speculative as tsv
from tputopo_torch import train as tr

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
# Two slots, chunked prefill over two buckets: the third request waits for
# a slot, long prompts prefill over several ticks.
ENGINE = dict(slots=2, max_len=32, prompt_pad=(4, 8), prefill_chunk=4)
LENS, NEWS = (3, 8, 5, 7, 2), (5, 4, 6, 3, 4)
LR = 1e-2


@pytest.fixture(scope="module")
def weights():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 64, n).tolist() for n in LENS]


def _serve(params, *, stream=True, tracer=None, cls=ts.ServingEngine, **kw):
    """The stream through an engine -> (rows in submission order, streamed
    tokens by request, the engine)."""
    got: dict = {}
    on_tokens = (lambda rid, toks: got.setdefault(rid, []).extend(toks)) if stream else None
    eng = cls(params, TCFG, on_tokens=on_tokens, tracer=tracer, **(kw or ENGINE))
    ids = [eng.submit(p, max_new=m) for p, m in zip(_prompts(), NEWS)]
    res = eng.run()
    return [res[i] for i in ids], got, eng


def _by_id(export):
    return {s["id"]: s for s in export["spans"]}


def test_each_tick_has_its_five_phases_and_children_lie_inside(weights):
    tracer = obs.Tracer()
    _, _, eng = _serve(weights[1], tracer=tracer)
    out = tracer.export()
    spans = _by_id(out)
    ticks = [s for s in out["spans"] if s["name"] == "tick"]
    assert ticks and out["ticks"] == len(ticks)
    for t in ticks:
        assert t["parent"] is None
        kids = sorted((s for s in out["spans"] if s["parent"] == t["id"]),
                      key=lambda s: s["start"])
        assert [k["name"] for k in kids] == list(obs.PHASES)
    for s in out["spans"]:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"], (s, p)
    # every program call is a span of its phase (the phase "admit" shares
    # its name with the program), over a dispatch; its replay (eager on the
    # CPU) is a device span under it
    ticks_ids = {t["id"] for t in ticks}
    calls = [s for s in out["spans"]
             if s["name"] in ts._PROGRAMS and s["parent"] not in ticks_ids]
    assert {c["name"] for c in calls} == {"admit", "prefill_chunk", "admit_final_chunk",
                                          "decode_step"}
    assert {spans[c["parent"]]["name"] for c in calls} == {"prefill", "admit", "decode"}
    replays = [d for d in out["device"] if d["name"] == "replay"]
    assert len(replays) == len(calls)
    assert {d["parent"] for d in replays} == {c["id"] for c in calls}
    assert all(d["call"] == "eager" and d["ms"] >= 0 for d in replays)
    dispatch = [s for s in out["spans"] if s["name"] == "dispatch"]
    assert {s["parent"] for s in dispatch} == {c["id"] for c in calls}
    decode = [c for c in calls if c["name"] == "decode_step"]
    assert len(decode) == eng.metrics["decode_steps"]
    assert all(c["steps"] == 1 for c in decode)
    admits = [c for c in calls if c["name"] != "decode_step"]
    assert sum(c["prompt_tokens"] for c in admits) == sum(LENS)
    assert len([c for c in calls if "chunk" in c["name"]]) == eng.metrics["prefill_chunks"]
    assert out["engine"] == eng.metrics
    assert out["programs"] == eng.programs.counts()
    assert out["dropped"] == 0


def test_readbacks_count_every_read_through_the_helper(weights, monkeypatch):
    calls = {"n": 0}
    read = ts.ServingEngine._read

    def counted(self, t):
        calls["n"] += 1
        return read(self, t)

    monkeypatch.setattr(ts.ServingEngine, "_read", counted)
    tracer = obs.Tracer()
    _serve(weights[1], tracer=tracer)
    c = tracer.export()["counters"]
    assert c["readbacks"] == calls["n"] > 0
    by_phase = {k.split(".", 1)[1]: v for k, v in c.items() if k.startswith("readbacks.")}
    assert sum(by_phase.values()) == c["readbacks"]
    assert set(by_phase) <= set(obs.PHASES) | {obs.CALLER}
    assert {"harvest", "decode", "stream"} <= set(by_phase)


@pytest.mark.parametrize("stream", [True, False])
def test_request_events_are_ordered_and_a_queued_request_waits_a_tick(weights, stream):
    tracer = obs.Tracer()
    rows, _, eng = _serve(weights[1], tracer=tracer, stream=stream)
    out = tracer.export()
    reqs = out["requests"]
    assert sorted(reqs) == list(range(len(LENS)))
    for ev in reqs.values():
        assert ev["queued"] <= ev["admitted"] <= ev["first_token"] <= ev["finished"]
    # an admission program's span carries its request's id, and starts once
    # the request is admitted
    calls = [s for s in out["spans"] if "rid" in s]
    assert {s["name"] for s in calls} == {"admit", "prefill_chunk", "admit_final_chunk"}
    assert {s["rid"] for s in calls} == set(reqs)
    for s in calls:
        assert s["start"] >= reqs[s["rid"]]["admitted"]
    # all five are submitted before the first tick into two slots: the third
    # waits at least one whole tick
    ticks = [(s["start"], s["end"]) for s in out["spans"] if s["name"] == "tick"]
    third = reqs[2]
    assert any(third["queued"] <= a and b <= third["admitted"] for a, b in ticks)


def test_stall_split_sums_to_the_total(weights):
    tracer = obs.Tracer()
    _serve(weights[1], tracer=tracer)
    stall = tracer.export()["stall"]
    assert stall["intervals"] > 0 and stall["ms"] > 0
    assert sum(stall["by_phase"].values()) == pytest.approx(stall["ms"], rel=1e-9)
    assert set(stall["by_phase"]) <= set(obs.PHASES) | {"tick", obs.CALLER}


def test_stall_split_on_a_known_clock(monkeypatch):
    """The split by phase, by hand: a tick from 100 to 200 ns with a harvest
    100-120 and a decode 150-190; a readback at 110 whose stall ends at the
    launch at 160 (10 ns harvest, 30 tick, 10 decode), and one at 195 in
    the tick whose stall ends outside it at 230 (5 tick, 30 caller)."""
    now = {"t": 0}
    monkeypatch.setattr(time, "perf_counter_ns", lambda: now["t"])
    tracer = obs.Tracer()

    def at(t):
        now["t"] = t

    at(100)
    with tracer.span("tick"):
        with tracer.span("harvest"):
            at(110)
            tracer.readback()
            at(120)
        at(150)
        with tracer.span("decode"):
            at(160)
            tracer.launched()
            at(190)
        at(195)
        tracer.readback()
        at(200)
    at(230)
    tracer.launched()
    out = tracer.export()
    assert out["ticks"] == 1
    assert out["stall"]["intervals"] == 2
    assert out["stall"]["ms"] == pytest.approx(85e-6)
    want = {"harvest": 10e-6, "tick": 35e-6, "decode": 10e-6, obs.CALLER: 30e-6}
    assert out["stall"]["by_phase"] == pytest.approx(want)
    assert out["counters"] == {"readbacks": 2, "readbacks.harvest": 1, "readbacks.tick": 1}


def test_tracing_changes_no_token_or_metric_and_matches_jax(weights):
    jp, tp = weights
    plain, plain_stream, plain_eng = _serve(tp)
    traced, traced_stream, traced_eng = _serve(tp, tracer=obs.Tracer())
    assert traced == plain and traced_stream == plain_stream
    assert traced_eng.metrics == plain_eng.metrics
    je = js.ServingEngine(jp, JCFG, **ENGINE)
    ids = [je.submit(p, max_new=m) for p, m in zip(_prompts(), NEWS)]
    res = je.run()
    assert traced == [res[i] for i in ids]
    assert traced_eng.metrics == je.metrics


def test_speculative_engine_inherits_the_spans(weights):
    kw = dict(slots=2, max_len=28, prompt_pad=(4, 8), draft_layers=1, gamma=2)
    plain, _, plain_eng = _serve(weights[1], cls=tsv.SpecServingEngine, **kw)
    tracer = obs.Tracer()
    traced, _, eng = _serve(weights[1], cls=tsv.SpecServingEngine, tracer=tracer, **kw)
    assert traced == plain and eng.metrics == plain_eng.metrics
    out = tracer.export()
    names = {s["name"] for s in out["spans"]}
    assert {"tick", *obs.PHASES, "admit", "_draft_prefill", "spec_tick"} <= names
    assert out["counters"]["readbacks.decode"] >= 2 * eng.metrics["decode_steps"]


def test_an_untraced_tick_reads_no_clock(weights, monkeypatch):
    eng = ts.ServingEngine(weights[1], TCFG, on_tokens=lambda rid, toks: None, **ENGINE)
    for p, m in zip(_prompts(), NEWS):
        eng.submit(p, max_new=m)

    def refuse():
        raise AssertionError("an untraced engine read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    for _ in range(4):
        eng.step()
    assert eng.tracer is None and eng.programs.tracer is None
    assert eng.metrics["decode_steps"] > 0


def _annotations(prof) -> list:
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.activity_type() == "user_annotation"]


def test_the_program_opens_no_profiler_range(weights):
    tracer = obs.Tracer()
    eng = ts.ServingEngine(weights[1], TCFG, on_tokens=lambda rid, toks: None,
                           tracer=tracer, **ENGINE)
    for p, m in zip(_prompts(), NEWS):
        eng.submit(p, max_new=m)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.step()
    assert tracer.export()["ticks"] == 3
    assert _annotations(prof) == []


def test_the_epoch_clock_lies_on_the_profilers(weights):
    tracer = obs.Tracer()
    eng = ts.ServingEngine(weights[1], TCFG, on_tokens=lambda rid, toks: None,
                           tracer=tracer, **ENGINE)
    for p, m in zip(_prompts(), NEWS):
        eng.submit(p, max_new=m)
    eng.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe.step"):
            eng.step()
    probe = next(e for e in prof.profiler.kineto_results.events()
                 if e.name() == "probe.step")
    tick = [s for s in tracer.export()["spans"] if s["name"] == "tick"][-1]
    assert abs(tick["epoch_start"] - probe.start_ns()) < 5e6
    assert abs(tick["epoch_end"] - (probe.start_ns() + probe.duration_ns())) < 5e6


def test_capacity_bounds_what_is_kept(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    tracer = obs.Tracer()
    for _ in range(5):
        with tracer.span("x"):
            pass
    out = tracer.export()
    assert len(out["spans"]) == 3 and out["dropped"] == 2


def _train(tracer, steps=3):
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 16)))
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        state = tr.make_sharded_state(plan, TCFG, 3, lr=LR)
        step = tr.make_sharded_train_step(plan, TCFG, lr=LR, tracer=tracer)
        losses = []
        for _ in range(steps):
            state, loss = step(state, tokens)
            losses.append(loss.item())
    return losses, [t.clone() for t in tr._leaves(state.params)]


def test_traced_train_step_splits_forward_backward_optimizer():
    tracer = obs.Tracer()
    losses, params = _train(tracer)
    want_losses, want_params = _train(None)
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
    out = tracer.export()
    assert set(out["laps"]) == {"train.forward", "train.backward", "train.optimizer"}
    assert all(v >= 0 for v in out["laps"].values())
    laps = [d for d in out["device"] if "group" in d]
    assert [d["name"] for d in laps] == ["train.forward", "train.backward",
                                         "train.backward", "train.optimizer"] * 3
    # the step's replay (eager under gloo) holds its laps
    replays = [d for d in out["device"] if d["name"] == "replay"]
    assert len(replays) == 3 and all(d["call"] == "eager" for d in replays)
    last = [d for d in laps if d["group"] == 3]
    assert sum(d["ms"] for d in last) <= replays[-1]["ms"]
    assert out["programs"]["captures"] == {}


class _Unrun:
    """A CUDA event that was captured into a graph and never replayed."""

    def elapsed_time(self, other):
        raise RuntimeError("event not recorded")


def test_laps_come_from_the_last_group_alone(monkeypatch):
    """A last lap group that reads None in part (captured, not yet
    replayed) gives no laps: an earlier group, such as the capture's eager
    warm-up, is never reported in its place."""
    tracer = obs.Tracer()
    tracer.lap_group("cpu")
    tracer.lap("train.forward", "cpu")
    tracer.lap("train.optimizer", "cpu")
    assert set(tracer.export()["laps"]) == {"train.forward", "train.optimizer"}
    monkeypatch.setattr(tracer, "mark", lambda device: _Unrun())
    tracer.lap_group("cpu")
    tracer.lap("train.forward", "cpu")
    tracer.lap("train.optimizer", "cpu")
    out = tracer.export()
    assert [d["ms"] is None for d in out["device"]] == [False, False, True, True]
    assert out["laps"] == {}


def test_replayed_programs_tag_their_capture_and_replays(weights, monkeypatch):
    """Through the CPU stand-in of a graph (tests/test_torch_compiled.py):
    a call that captures has a replay tagged capture under its program's
    span; every later call a replay tagged replay."""
    from tests.test_torch_compiled import _stand_in_capture

    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)
    plain, _, _ = _serve(weights[1])
    tracer = obs.Tracer()
    traced, _, eng = _serve(weights[1], tracer=tracer)
    assert traced == plain
    out = tracer.export()
    spans = _by_id(out)
    captures, replays = eng.programs.captures, eng.programs.replays
    tags = [d["call"] for d in out["device"] if d["name"] == "replay"]
    assert tags.count("capture") == sum(captures.values())
    assert tags.count("replay") == sum(replays.values()) - sum(captures.values())
    cap = [d for d in out["device"] if d["name"] == "replay" and d["call"] == "capture"]
    assert sorted(spans[d["parent"]]["name"] for d in cap) == sorted(captures.elements())
    calls = {s["parent"] for s in out["spans"] if s["name"] == "dispatch"}
    assert len(calls) == sum(replays.values())
