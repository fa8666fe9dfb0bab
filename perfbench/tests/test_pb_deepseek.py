"""The ``deepseekv3.longdoc`` cell: its configuration against the catalog's
DeepSeek-V3, its traffic and entries; its driver at a tiny size on the CPU
(the program in float32), sound, with each named fault planted in the
program, and on a program without latent attention; and its per-layer
readers on synthetic records."""

import copy
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench.harness import common, deepseek, latent, traffic
from perfbench.harness.common import BENCH, ROOT, load_json, load_module
from perfbench.harness.core import execute

CPU = torch.device("cpu")
SEED = 4_000_000_037
CELL = "deepseekv3.longdoc"
CATALOG = {"attention_bias": False, "ep_size": 1, "first_k_dense_replace": 3,
           "hidden_act": "silu", "hidden_size": 7168, "intermediate_size": 18432,
           "kv_lora_rank": 512, "max_position_embeddings": 163840,
           "model_type": "deepseek_v3", "moe_intermediate_size": 2048, "moe_layer_freq": 1,
           "n_group": 8, "n_routed_experts": 256, "n_shared_experts": 1,
           "norm_topk_prob": True, "num_attention_heads": 128, "num_experts_per_tok": 8,
           "num_hidden_layers": 61, "num_key_value_heads": 128,
           "num_nextn_predict_layers": 1, "q_lora_rank": 1536, "qk_nope_head_dim": 128,
           "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
           "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1,
                            "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                            "type": "yarn"},
           "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
           "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
           "v_head_dim": 128, "vocab_size": 129280}
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 4, "v_head_dim": 8, "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 32,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1},
        "rms_norm_eps": 1e-6, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "intermediate_size": 96, "moe_intermediate_size": 32, "n_shared_experts": 1,
        "router_experts": 16, "n_routed_experts": 4, "experts_held": [0, 4],
        "n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
        "routed_scaling_factor": 2.5, "norm_topk_prob": True, "scoring_func": "sigmoid",
        "topk_method": "noaux_tc", "vocab_size": 128, "max_position_embeddings": 512,
        "router_bias_std": 0.05}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_configuration_keeps_every_published_width_and_states_its_cut():
    m = common.workload(CELL)["model"]
    entry = next(c for c in _bench()["configs"] if c["name"] == "deepseek-v3-l7-ep32")
    assert entry["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert load_json(ROOT / entry["file"]) == m
    changed = {k for k, v in CATALOG.items() if m[k] != v}
    assert changed == set(entry["reduced"]) == set(m["reduced"])
    assert m["reduced"] == {"num_hidden_layers": 61, "n_routed_experts": 256}
    assert (m["num_hidden_layers"], m["n_routed_experts"], m["router_experts"],
            m["experts_held"]) == (7, 8, 256, [0, 8])
    assert abs(deepseek.n_params(m) / 1e9 - 5.94) < 0.01
    assert m["router_bias_std"] > 0 and "deployment" in m and "assumed" in m
    cfg = deepseek.model_config(m)
    assert (cfg.mla.q_rank, cfg.mla.kv_rank, cfg.mla.nope, cfg.mla.rope, cfg.mla.v,
            cfg.mla.factor) == (1536, 512, 128, 64, 128, 40.0)
    assert (cfg.moe.n_experts, cfg.moe.held, cfg.moe.n_group, cfg.moe.topk_group,
            cfg.moe.first_dense, cfg.moe.n_shared) == (256, (0, 8), 8, 4, 3, 1)


def test_cell_entry_and_the_metrics_it_reports():
    bench = _bench()
    w = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("deepseek-v3-l7-ep32", "longdoc_mla", 1)
    e2e, layer = common.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"gen_tokens_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {
        "mla_share.deepseekv3_longdoc", "mla_roofline.deepseekv3_longdoc",
        "replay_decode_ms.deepseekv3_longdoc",
        "replay_prefill_ms_per_ktok.deepseekv3_longdoc", "mfu.deepseekv3_longdoc",
        "device_idle.longdoc"}
    assert all(m["moves"] == "gen_tokens_per_s" for m in layer)
    cell = common.workload(CELL)
    assert cell["engine"] == {"slots": 32, "max_len": 32768,
                              "prompt_pad": [8192, 16384, 28672],
                              "prefill_chunk": 2048, "steps_per_tick": 8}
    assert cell["backlog"] == 48 and cell["check"] == {"served_tokens": 300,
                                                       "max_requests": 3}


def test_traffic_is_a_long_document_backlog():
    mix = load_json(BENCH / "traffic" / "longdoc_mla.json")
    reqs = traffic.requests(mix, SEED, 129280, 45)
    again = traffic.requests(mix, SEED + 1, 129280, 45)
    assert len(reqs) == 192 and all(r.due == 0 for r in reqs)
    assert [(len(r.prompt), r.max_new) for r in reqs] == \
        [(len(r.prompt), r.max_new) for r in again]
    assert all(8192 <= len(r.prompt) <= 28672 and 64 <= r.max_new <= 1024 for r in reqs)
    first = sorted(len(r.prompt) for r in reqs[:32])
    assert first[0] < 8192 + 640 and first[-1] > 28672 - 640  # set-up spans the range


@pytest.fixture(autouse=True)
def float32_program(monkeypatch):
    make_config = deepseek.model_config
    monkeypatch.setattr(deepseek, "model_config", lambda m: dataclasses.replace(
        make_config(m), compute_dtype=torch.float32))


def tiny_cell() -> dict:
    c = copy.deepcopy(common.workload(CELL))
    c["model"] = dict(TINY)
    c["engine"].update(slots=4, max_len=200, prompt_pad=[32, 64, 96], prefill_chunk=16)
    c["traffic_mix"]["prompt"].update(min=24, max=96)
    c["traffic_mix"]["output"].update(min=4, max=32, median=8)
    c["backlog"] = 6
    c["check"] = {"served_tokens": 40, "max_requests": 2}
    # float32 on both sides: a sound run reads rounding only
    c["limits"] = {"served_gap": 1e-3, "route_gap": 1e-3}
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
    assert set(res["metrics"]) == {"gen_tokens_per_s", "setup_s"}


FAULT_CAUGHT_BY = {"no_mscale": "served_gap", "unroped_k": "served_gap",
                   "no_kv_norm": "served_gap", "no_bias": "route_gap",
                   "no_group_limit": "route_gap", "unscaled": "served_gap",
                   "no_shared": "served_gap"}


@pytest.mark.parametrize("fault", sorted(FAULT_CAUGHT_BY))
def test_each_named_fault_is_caught(fault, monkeypatch):
    from perfbench import control_deepseek
    from tputopo_torch import mla, moe

    for mod, name in ((mla, "softmax_scale"), (mla, "latent_row"),
                      (moe, "_sigmoid_gates"), (moe, "_shared_expert")):
        monkeypatch.setattr(mod, name, getattr(mod, name))  # restored after the test
    control_deepseek.plant(fault)
    assert FAULT_CAUGHT_BY[fault] in over(run(tiny_cell()))


def test_a_program_without_latent_attention_stops_at_once(monkeypatch):
    driver = load_module("drivers", "serve_backlog_routed")
    from tputopo_torch import model

    fields = {k: v for k, v in model.ModelConfig.__dataclass_fields__.items() if k != "mla"}
    monkeypatch.setattr(model.ModelConfig, "__dataclass_fields__", fields)
    assert not driver.supported()
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        driver.run(None)
    assert e.value.code not in (0, None) and time.perf_counter() - t0 < 1.0


def test_traced_run_records_the_stretch_counts():
    """On the CPU the programs run eagerly and there is no device clock: the
    device readers read None, and the record holds the snapshots and the
    export they read."""
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
    assert res["correct"]
    rec = seen["rec"]
    marks = rec["stretch_counts"]
    assert marks["stop"]["mla"]["calls"] >= marks["start"]["mla"]["calls"] > 0
    assert rec["program_trace"]["mla"]["device_ns"] == 0
    assert "mla_share.deepseekv3_longdoc" not in res["metrics"]
    assert "mla_roofline.deepseekv3_longdoc" not in res["metrics"]


MODEL = load_json(BENCH / "configs" / "deepseek-v3-l7-ep32.json")
ROOF = load_module("metrics", "mla_roofline.deepseekv3_longdoc")
SHARE = load_module("metrics", "mla_share.deepseekv3_longdoc")
MFU = load_module("metrics", "mfu.deepseekv3_longdoc")


def _counts(**kw):
    d = {f"{k}_{f}": 0 for k in latent.KINDS
         for f in ("calls", "queries", "rows", "pairs", "ns")}
    d.update(kw)
    d["calls"] = d["decode_calls"] + d["prefill_calls"]
    d["device_ns"] = d["decode_ns"] + d["prefill_ns"]
    return d


def _rec(stop, busy=1.0):
    return {"model": MODEL, "profile": {"busy_s": busy},
            "stretch_counts": {"start": {"mla": _counts()}, "stop": {"mla": stop}}}


def test_roofline_counts_the_cheaper_form_of_each_call():
    # one decode step of 32 slots at 18432 positions each, 7 layers: the
    # absorbed form's flops (278,528 a pair) against the rows' bytes
    rows = 32 * 18432 * 7
    d = _counts(decode_calls=7, decode_queries=32 * 7, decode_rows=rows, decode_pairs=rows,
                decode_ns=10**7)
    f = 2.0 * 128 * (2 * 512 + 64) * rows
    b = 2.0 * (rows * 576 + 32 * 7 * 128 * 320)
    least = max(f / 989e12, b / 3.35e12)
    assert math.isclose(ROOF.read(_rec(d)), 100 * least / 1e-2)
    assert 0 < ROOF.read(_rec(d)) < 100
    # a prefill chunk of 2048 at start 16384: the expanded form's flops
    pairs = 2048 * 16385 + 2048 * 2047 // 2
    p = _counts(prefill_calls=1, prefill_queries=2048, prefill_rows=16384 + 2048,
                prefill_pairs=pairs, prefill_ns=10**7)
    want = 2.0 * 128 * 320 * pairs + 2.0 * 512 * 128 * 256 * (16384 + 2048)
    assert math.isclose(latent.flops(MODEL, 16384 + 2048, pairs), want)
    assert want < 2.0 * 128 * (2 * 512 + 64) * pairs
    assert ROOF.read(_rec(_counts())) is None


def test_share_is_the_latent_time_over_the_busy_time():
    d = _counts(decode_calls=7, decode_ns=3 * 10**8, prefill_calls=7, prefill_ns=2 * 10**8)
    assert math.isclose(SHARE.read(_rec(d, busy=2.0)), 25.0)
    assert SHARE.read({"model": MODEL}) is None


def test_mfu_counts_prefill_and_decode_tokens():
    rec = {"model": MODEL, "window_s": 10.0,
           "programs": [{"name": "prefill_chunk", "prompt_tokens": 2048, "first_pos": 0,
                         "ms": 1.0, "steps": None}],
           "requests": [{"prompt_len": 8192, "generated": 11, "before_window": 1}]}
    per_tok, per_pair = latent.token_flops(MODEL), latent.pair_flops(MODEL)
    want = 2048 * per_tok + per_pair * 2048 * 2049 / 2
    want += 10 * per_tok + per_pair * (10 * 8192 + 10 * 11 / 2)
    assert math.isclose(MFU.read(rec), 100 * want / (10.0 * 989e12))
    assert 0 < MFU.read(rec) < 100
