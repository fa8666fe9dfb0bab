"""The arithmetic of the end-to-end and per-layer metrics."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import serving
from perfbench.harness.common import BENCH, ROOT, load_json, load_module, percentile
from perfbench.harness.traffic import Request


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 0.9) == 90
    assert percentile(xs, 0.5) == 50
    assert percentile([3.0], 0.9) == 3.0
    assert percentile([], 0.9) is None
    assert percentile(list(range(1, 11)), 0.95) == 10


def _served(due, first, last, n):
    r = serving.Served(Request(0, due, [1, 2, 3], n))
    r.first, r.last, r.tokens = first, last, [0] * (n if first is not None else 0)
    return r


def test_window_with_a_stall():
    """A stall from 4 s to 9 s of a 10 s window: requests due inside it wait,
    and the one that never got a token counts at its wait so far."""
    t0, stop = 100.0, 110.0
    served = [_served(d, t0 + d + 0.1, t0 + d + 0.1 + 0.05 * 9, 10) for d in range(4)]
    served += [_served(5.0, t0 + 9.2, t0 + 9.9, 8), _served(9.5, None, None, 0)]
    ttft = [(r.first if r.first is not None else stop) - (t0 + r.req.due) for r in served]
    assert ttft[-1] == pytest.approx(0.5)
    assert percentile(ttft, 0.9) == pytest.approx(4.2)
    tpot = [(r.last - r.first) / (len(r.tokens) - 1) * 1e3 for r in served if len(r.tokens) >= 2]
    assert tpot[:4] == pytest.approx([50.0] * 4) and tpot[4] == pytest.approx(100.0)
    out = {"ttft": ttft, "tpot": tpot, "generated": sum(len(r.tokens) for r in served),
           "window_s": stop - t0}
    e2e = serving.end_to_end(out)
    assert e2e["gen_tokens_per_s"] == pytest.approx(48 / 10)
    assert e2e["ttft_p90_s"] == pytest.approx(4.2)
    assert e2e["tpot_p90_ms"] == pytest.approx(100.0)


FLASH = load_module("metrics", "flash_roofline.train")


@pytest.mark.parametrize("kind, gflop, mb", [("flash_fwd", 34.4, 67.4),
                                             ("flash_dq", 51.6, 84.4),
                                             ("flash_dkv", 68.7, 101.2)])
def test_flash_counts_match_the_kernel_table(kind, gflop, mb):
    """PERF.md's kernel table: B.N 32, S 2048, H 128, causal, bf16."""
    flops, nbytes = FLASH.flops_bytes(1, 2048, 32, 128, *FLASH.KINDS[kind])
    assert abs(flops / 1e9 - gflop) < 0.06
    assert abs(nbytes / 1e6 - mb) < 0.06


def test_flash_roofline_reader():
    model = load_json(BENCH / "configs" / "mistral-7b-v0.3-pp4.json")
    one = FLASH.bound_s(4, 4096, 32, 128, *FLASH.KINDS["flash_fwd"])
    rec = {"model": model, "batch": 4, "seq": 4096,
           "profile": {"kernels": {"void flash_fwd_sm90<2>(...)": [16, 16 * 2 * one],
                                   "elementwise": [5, 1.0]}}}
    assert FLASH.read(rec) == pytest.approx(50.0)
    rec["profile"]["kernels"] = {"elementwise": [5, 1.0]}
    assert FLASH.read(rec) is None


MFU = load_module("metrics", "mfu.train")


@pytest.mark.parametrize("config, batch, seq, tflop", [
    ("mistral-7b-v0.3-pp4", 4, 4096, 197.9),
    ("mixtral-8x7b-v0.1-l1", 1, 4096, 13.3),
    ("mistral-7b-v0.3", 1, 4096, 188.0),
])
def test_train_step_flops(config, batch, seq, tflop):
    model = load_json(BENCH / "configs" / f"{config}.json")
    assert round(MFU.step_flops(model, batch, seq) / 1e12, 1) == tflop


def test_mfu_readers():
    model = load_json(BENCH / "configs" / "mistral-7b-v0.3-pp4.json")
    f = MFU.step_flops(model, 4, 4096)
    rec = {"model": model, "batch": 4, "seq": 4096, "steps": 10, "window_s": 10 * f / 989e12}
    assert MFU.read(rec) == pytest.approx(100.0)
    served = load_module("metrics", "mfu.longdoc")
    m = load_json(BENCH / "configs" / "mistral-7b-v0.3.json")
    # one 1000-token prompt prefilled from 0, then 11 tokens generated
    # (10 decode steps feeding positions 1000..1009)
    f = served.window_flops(m, [(0, 1000)], [served.decode_steps(1000, 11, 0)])
    per_tok, per_pair = 2 * 7_113_539_584, 4 * 32 * 32 * 128
    want = 1010 * per_tok + per_pair * (1000 * 1001 / 2 + sum(range(1001, 1011)))
    assert f == pytest.approx(want)
    # a request admitted in set-up with 4 tokens: the window's steps make 5..11
    assert served.decode_steps(1000, 11, 4) == (1003, 7)


def test_idle_and_span_readers():
    rec = {"profile": {"busy_s": 0.75, "window_s": 1.0}, "tick_ms": [10.0, 20.0],
           "programs": [{"name": "decode_steps", "ms": 80.0, "steps": 8,
                         "prompt_tokens": None, "first_pos": None},
                        {"name": "prefill_chunk", "ms": 30.0, "prompt_tokens": 512,
                         "first_pos": 0, "steps": None},
                        {"name": "admit_final_chunk", "ms": 20.0, "prompt_tokens": 488,
                         "first_pos": 512, "steps": None}]}
    assert load_module("metrics", "device_idle.chat").read(rec) == pytest.approx(25.0)
    assert load_module("metrics", "tick_ms.chat").read(rec) == pytest.approx(15.0)
    assert load_module("metrics", "decode_step_ms.longdoc").read(rec) == pytest.approx(10.0)
    assert load_module("metrics", "prefill_ms_per_ktok.longdoc").read(rec) == \
        pytest.approx(50.0)
    # a run whose spans found nothing reports nothing
    assert load_module("metrics", "decode_step_ms.chat").read({"programs": []}) is None
    assert load_module("metrics", "device_idle.train").read({"profile": None}) is None


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mistral7b.chat",
                           "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = load_json(BENCH / "workloads" / f"{w['name']}.json")
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert math.isclose(bench["end_to_end"][-1]["bound"], 0.25)
