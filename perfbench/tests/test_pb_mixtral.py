"""The ``mixtral.chat`` cell: its configuration, traffic and entries; its
driver at a tiny size on the CPU (the program in float32), sound and with
faults planted in the program's routing; the check that replays the
program's expert choices; and the cell's per-layer readers on synthetic
records."""

import copy
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench.harness import common, traffic
from perfbench.harness.common import BENCH, ROOT, load_json, load_module
from perfbench.harness.core import execute
from perfbench.harness.weights import n_params

from conftest import TINY_MOE

CPU = torch.device("cpu")
SEED = 4_000_000_019
CELL = "mixtral.chat"


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_configuration_is_mixtral_at_published_widths_cut_to_8_layers():
    m = common.workload(CELL)["model"]
    assert (m["hidden_size"], m["intermediate_size"], m["num_attention_heads"],
            m["num_key_value_heads"], m["head_dim"], m["vocab_size"]) == \
        (4096, 14336, 32, 8, 128, 32000)
    assert (m["num_local_experts"], m["num_experts_per_tok"]) == (8, 2)
    assert m["num_hidden_layers"] == 8 and m["reduced"] == {"num_hidden_layers": 32}
    assert abs(n_params(m) / 1e9 - 11.87) < 0.01
    entry = next(c for c in _bench()["configs"] if c["name"] == "mixtral-8x7b-v0.1-pp4")
    assert entry["reduced"] == ["num_hidden_layers"]
    assert load_json(ROOT / entry["file"]) == {k: v for k, v in m.items()}


def test_cell_entry_and_the_metrics_it_reports():
    bench = _bench()
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("mixtral-8x7b-v0.1-pp4",
                                                       "chat_mixtral", 1)
    e2e, layer = common.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"ttft_p90_s", "tpot_p90_ms", "setup_s"}
    assert {m["name"] for m in layer} == {
        "moe_roofline.mixtral_chat", "moe_share.mixtral_chat",
        "replay_decode_ms.mixtral_chat", "replay_prefill_ms_per_ktok.mixtral_chat"}
    bounds = {m["name"]: m["bound"] for m in bench["end_to_end"]}
    assert (bounds["ttft_p90_s"], bounds["tpot_p90_ms"]) == (0.2, 0.05)


def test_traffic_is_chats_lengths_at_its_own_rate():
    chat = load_json(BENCH / "traffic" / "chat.json")
    mix = load_json(BENCH / "traffic" / "chat_mixtral.json")
    assert {k: mix[k] for k in ("prompt", "output", "block")} == \
        {k: chat[k] for k in ("prompt", "output", "block")}
    assert mix["arrival"]["kind"] == "poisson" and str(mix["arrival"]["rate"]) in mix["about"]
    reqs = traffic.requests(mix, SEED, 32000, 45)
    assert len(reqs) == round(mix["arrival"]["rate"] * 45)
    again = traffic.requests(mix, SEED + 1, 32000, 45)
    assert [(r.due, len(r.prompt), r.max_new) for r in reqs] == \
        [(r.due, len(r.prompt), r.max_new) for r in again]
    assert all(16 <= len(r.prompt) <= 1024 and 16 <= r.max_new <= 512 for r in reqs)


@pytest.fixture(autouse=True)
def float32_program(monkeypatch):
    from perfbench.harness import port

    make_config = port.model_config
    monkeypatch.setattr(port, "model_config", lambda m: dataclasses.replace(
        make_config(m), compute_dtype=torch.float32))


def tiny_cell() -> dict:
    """The cell as committed, on the tiny MoE model and tiny shapes."""
    c = copy.deepcopy(common.workload(CELL))
    c["model"] = dict(TINY_MOE)
    c["engine"].update(max_len=160, prompt_pad=[16, 32, 64], prefill_chunk=16)
    c["traffic_mix"]["prompt"].update(min=4, max=64, median=20)
    c["traffic_mix"]["output"].update(min=2, max=24, median=8)
    c["traffic_mix"]["arrival"]["rate"] = 6
    c["check"] = {"served_tokens": 60, "max_requests": 4}
    return c


def run(cell, trace=False):
    return execute(cell, common.benchmark(), SEED, 2.0, trace, CPU, time.perf_counter())


def over(result):
    return sorted(k for k, c in result["checks"].items()
                  if c["limit"] is None or not c["value"] <= c["limit"])


def test_sound_run_is_correct_and_checks_both_numbers():
    res = run(tiny_cell())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"served_gap", "route_gap"}
    assert set(res["metrics"]) == {"ttft_p90_s", "tpot_p90_ms", "setup_s"}


def _plant(monkeypatch, rule):
    from tputopo_torch import moe

    monkeypatch.setattr(moe, "_top_k_gates", rule)


def test_top1_routing_is_caught(monkeypatch):
    from tputopo_torch import moe

    sound = moe._top_k_gates

    def top1(x32, router, m):
        gates, idx = sound(x32, router, m)
        return torch.nn.functional.one_hot(torch.zeros_like(idx[..., 0]), m.top_k).float(), idx

    _plant(monkeypatch, top1)
    assert "served_gap" in over(run(tiny_cell()))


def test_unnormalised_gates_are_caught(monkeypatch):
    def unnormalised(x32, router, m):
        return torch.topk(torch.softmax(x32 @ router.float(), dim=-1), m.top_k, dim=-1)

    _plant(monkeypatch, unnormalised)
    assert "served_gap" in over(run(tiny_cell()))


def test_experts_chosen_by_a_wrong_rule_are_caught(monkeypatch):
    """The program routes each token to its k least likely experts: the
    reference, replaying those choices, computes what the program did, and
    only the route gap can tell."""
    def bottom(x32, router, m):
        probs = torch.softmax(x32 @ router.float(), dim=-1)
        gates, idx = torch.topk(-probs, m.top_k, dim=-1)
        gates = -gates
        return gates / gates.sum(-1, keepdim=True), idx

    _plant(monkeypatch, bottom)
    assert "route_gap" in over(run(tiny_cell()))


def test_a_program_that_cannot_keep_its_routes_stops_at_once(monkeypatch):
    from tputopo_torch import serving

    init = serving.ServingEngine.__init__

    def old_init(self, params, config, *, slots, max_len, prompt_pad, eos_id=-1,
                 temperature=0.0, top_k=None, generator=None, steps_per_tick=1,
                 prefill_chunk=None, buffer_margin=0, on_tokens=None, tracer=None):
        init(self, params, config, slots=slots, max_len=max_len, prompt_pad=prompt_pad)

    monkeypatch.setattr(serving.ServingEngine, "__init__", old_init)
    with pytest.raises(SystemExit) as e:
        run(tiny_cell())
    assert e.value.code not in (0, None)


def test_traced_run_records_the_stretch_counts(monkeypatch):
    """The routed layer taken as on the card; on the CPU the programs run
    eagerly and there is no device clock: every reader of the cell reads
    None, and the record holds the snapshots and the export the readers
    take them from."""
    from tputopo_torch import moe

    monkeypatch.setattr(moe, "routed_takes", lambda x, p, cfg: True)
    cell = tiny_cell()
    driver = load_module("drivers", cell["driver"])
    seen = {}
    record = driver.serving.record

    def keep(ctx, out):
        seen["rec"] = rec = record(ctx, out)
        return rec

    driver.serving.record = keep
    try:
        res = run(cell, trace=True)
    finally:
        driver.serving.record = record
    assert res["correct"] and res["metrics"] == {}
    rec = seen["rec"]
    marks = rec["stretch_counts"]
    assert set(marks) == {"start", "stop"}
    assert marks["stop"]["moe"]["calls"] >= marks["start"]["moe"]["calls"] > 0
    assert rec["program_trace"]["moe"]["device_ns"] == 0


ROOF = load_module("metrics", "moe_roofline.mixtral_chat")
SHARE = load_module("metrics", "moe_share.mixtral_chat")
MODEL = load_json(BENCH / "configs" / "mixtral-8x7b-v0.1-pp4.json")
GROUPED = "void cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>(...)"


def _rec(calls, pairs, hit, kernel_s, busy=1.0, device_ns=0):
    zero = {"calls": 0, "pairs": 0, "experts_hit": 0, "max_load": 0, "device_ns": 0}
    return {"model": MODEL,
            "profile": {"busy_s": busy, "window_s": 1.2,
                        "kernels": {GROUPED: [3 * calls, kernel_s], "other": [9, 0.5]}},
            "stretch_counts": {"start": {"moe": zero, "grouped_mm": {"launches": 0}},
                               "stop": {"moe": {"calls": calls, "pairs": pairs,
                                                "experts_hit": hit, "max_load": 0,
                                                "device_ns": device_ns},
                                        "grouped_mm": {"launches": 3 * calls}}}}


def test_roofline_counts():
    """A decode step's layer at chat's 32 slots: 64 pairs over 8 experts
    reads the three bf16 tables (2.82 GB) and 64 rows in and out of each
    product; 64 x 6 D F flops."""
    flops, nbytes = ROOF.flops_bytes(MODEL, 64, 8)
    assert flops == pytest.approx(64 * 6 * 4096 * 14336)
    assert nbytes == pytest.approx(2 * (3 * 4096 * 14336 * 8 + 64 * 3 * (4096 + 14336)))
    assert ROOF.bound_s(MODEL, 64, 8) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("tokens, hit", [(32, 8), (1, 2), (128, 8), (2048, 8)])
def test_roofline_is_100_at_the_bound_and_below_it_otherwise(tokens, hit):
    calls, pairs = 80, 80 * tokens * 2
    need = ROOF.bound_s(MODEL, pairs, calls * hit)
    assert ROOF.read(_rec(calls, pairs, calls * hit, need)) == pytest.approx(100.0)
    for slower in (1.01, 1.5, 4.0):
        assert ROOF.read(_rec(calls, pairs, calls * hit, need * slower)) < 100.0


def test_readers_read_none_without_what_they_read():
    for reader in (ROOF, SHARE):
        assert reader.read({}) is None
        assert reader.read({"profile": {"busy_s": 1.0, "kernels": {}}}) is None
        rec = _rec(10, 640, 80, 0.1, device_ns=5e8)
        rec["stretch_counts"]["start"] = {"grouped_mm": {"launches": 0}}  # no moe counts
        assert reader.read(rec) is None
    for name in ("replay_decode_ms.mixtral_chat", "replay_prefill_ms_per_ktok.mixtral_chat"):
        assert load_module("metrics", name).read({"programs": []}) is None
    assert ROOF.read(_rec(10, 640, 80, 0.0)) is None  # no grouped kernel in the trace


def test_moe_share_is_the_layers_device_time_over_the_busy_time():
    assert SHARE.read(_rec(10, 640, 80, 0.1, busy=2.0, device_ns=1.5e9)) == \
        pytest.approx(75.0)
    assert SHARE.read(_rec(10, 640, 80, 0.1, busy=2.0, device_ns=0)) is None
    assert math.isfinite(SHARE.read(_rec(1, 64, 8, 0.1, busy=0.5, device_ns=1e8)))
