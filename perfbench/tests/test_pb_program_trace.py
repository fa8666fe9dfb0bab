"""The readers of the program's own tracer (``program_trace`` in a traced
run's record, the export of ``tputopo_torch.obs.Tracer``): None on a
record without it, the hand-computed value on a synthetic export, and
values that agree with the tracer's own counts on the export of a tiny
engine run on the CPU."""

import numpy as np
import pytest
import torch

from perfbench.harness.common import load_module
from perfbench.harness.weights import make

from conftest import TINY

READERS = ("stall_ms_per_tick.chat", "readbacks_per_tick.chat", "queue_wait_p90_s.chat",
           "prefill_wait_p90_s.chat", "replay_decode_ms.chat",
           "replay_prefill_ms_per_ktok.chat", "stall_ms_per_tick.longdoc",
           "replay_decode_ms.longdoc", "replay_prefill_ms_per_ktok.longdoc",
           "forward_ms.train", "backward_ms.train", "optimizer_ms.train")

# A record as the drivers wrote it before the program had a tracer: the
# benchmark's own events, tick spans and profile, and no program_trace.
OUTSIDE = {"programs": [{"name": "decode_step", "ms": 72.0, "steps": 1,
                         "prompt_tokens": None}],
           "tick_ms": [99.0, 98.0], "queue": [0, 1],
           "profile": {"busy_s": 0.87, "window_s": 1.0, "breakdown": []}}


def _read(name, rec):
    return load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_program_trace(name):
    assert _read(name, OUTSIDE) is None
    assert _read(name, {}) is None


def _export():
    """Four ticks.  Ten requests admitted, queue waits 0.1 ... 1.0 s and
    prefill waits 0.2 ... 2.0 s; one more still queued.  Decode: a one-step
    replay of 70 ms and a four-step replay of 300 ms under a tick; the
    capture, an eager call, a replay whose events never ran and a call
    outside every tick are not counted.  Admission: 300 + 128 + 72 prompt
    tokens in 90 + 40 + 25 ms of replay.  Train laps of the last step."""
    s = 1_000_000_000
    requests = {rid: {"queued": rid * s, "admitted": rid * s + rid * s // 10,
                      "first_token": rid * s + 3 * rid * s // 10}
                for rid in range(1, 11)}
    requests[11] = {"queued": 20 * s}
    spans = [{"id": 1, "parent": None, "name": "tick"},
             {"id": 2, "parent": 1, "name": "decode_step", "steps": 1},
             {"id": 3, "parent": 1, "name": "decode_steps", "steps": 4},
             {"id": 4, "parent": 1, "name": "decode_step", "steps": 1},
             {"id": 5, "parent": 1, "name": "decode_step", "steps": 1},
             {"id": 6, "parent": 1, "name": "decode_step", "steps": 1},
             {"id": 7, "parent": None, "name": "decode_step", "steps": 1},
             {"id": 8, "parent": 1, "name": "admit", "prompt_tokens": 300},
             {"id": 9, "parent": 1, "name": "prefill_chunk", "prompt_tokens": 128},
             {"id": 10, "parent": 1, "name": "admit_final_chunk", "prompt_tokens": 72},
             {"id": 11, "parent": 1, "name": "admit", "prompt_tokens": 50}]
    device = [{"name": "replay", "parent": 2, "call": "replay", "ms": 70.0},
              {"name": "replay", "parent": 3, "call": "replay", "ms": 300.0},
              {"name": "replay", "parent": 4, "call": "capture", "ms": 500.0},
              {"name": "replay", "parent": 5, "call": "eager", "ms": 80.0},
              {"name": "replay", "parent": 6, "call": "replay", "ms": None},
              {"name": "replay", "parent": 7, "call": "replay", "ms": 71.0},
              {"name": "replay", "parent": 8, "call": "replay", "ms": 90.0},
              {"name": "replay", "parent": 9, "call": "replay", "ms": 40.0},
              {"name": "replay", "parent": 10, "call": "replay", "ms": 25.0},
              {"name": "replay", "parent": 11, "call": "capture", "ms": 400.0}]
    return {"ticks": 4, "counters": {"readbacks": 26, "readbacks.harvest": 4},
            "stall": {"ms": 10.0, "intervals": 26, "by_phase": {"harvest": 10.0}},
            "requests": requests, "spans": spans, "device": device,
            "laps": {"train.forward": 223.5, "train.backward": 638.25,
                     "train.optimizer": 80.0}}


WANT = {"stall_ms_per_tick": 2.5, "readbacks_per_tick": 6.5, "queue_wait_p90_s": 0.9,
        "prefill_wait_p90_s": 1.8, "replay_decode_ms": 370.0 / 5,
        "replay_prefill_ms_per_ktok": 155.0 / 500 * 1000, "forward_ms": 223.5,
        "backward_ms": 638.25, "optimizer_ms": 80.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_export(name):
    got = _read(name, dict(OUTSIDE, program_trace=_export()))
    assert got == pytest.approx(WANT[name.split(".")[0]])


def test_no_ticks_no_admission_no_laps_read_none():
    empty = {"ticks": 0, "counters": {}, "stall": {"ms": 0.0}, "requests": {},
             "spans": [], "device": [], "laps": {}}
    for name in READERS:
        assert _read(name, {"program_trace": empty}) is None, name


def test_readers_on_a_tracers_export():
    """The export of a tiny engine traced on the CPU: the serving readers
    read what its counts say; the CPU runs every program eagerly, so the
    replay readers find no replay and read None."""
    import dataclasses

    from perfbench.harness.port import model_config
    from tputopo_torch.obs import Tracer
    from tputopo_torch.serving import ServingEngine

    params = make(TINY, 3, torch.device("cpu"))
    cfg = dataclasses.replace(model_config(TINY), compute_dtype=torch.float32)
    eng = ServingEngine(params, cfg, slots=2, max_len=96, prompt_pad=(16, 48),
                        prefill_chunk=16, on_tokens=lambda rid, t: None, tracer=Tracer())
    rng = np.random.default_rng(4)
    for n, new in ((5, 6), (40, 4), (16, 5)):
        eng.submit(rng.integers(0, TINY["vocab_size"], n), new)
    eng.run()
    pt = eng.tracer.export()
    rec = {"program_trace": pt}
    assert pt["ticks"] > 0 and len(pt["requests"]) == 3
    assert _read("readbacks_per_tick.chat", rec) == pt["counters"]["readbacks"] / pt["ticks"]
    assert _read("stall_ms_per_tick.chat", rec) == pt["stall"]["ms"] / pt["ticks"]
    waits = [_read(n, rec) for n in ("queue_wait_p90_s.chat", "prefill_wait_p90_s.chat")]
    assert all(w is not None and w >= 0 for w in waits)
    for name in READERS:
        if name.startswith(("replay_", "forward_", "backward_", "optimizer_")):
            assert _read(name, rec) is None, name
