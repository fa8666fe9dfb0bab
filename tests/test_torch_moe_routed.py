"""The routed, drop-free expert layer of serving (``moe.moe_mlp_routed``) on
the CPU: its twin of the grouped GEMM (a loop over the segments) against
the loop over the experts (``moe.moe_mlp_reference``) and against the
benchmark's plain reference (``perfbench/reference/model.py:experts``), in
float32 and in bfloat16; the engine's tokens through it; the counts a
tracer reads of it, against a recount on the host; and the rule that sends
a layer through it; the expert choices an engine keeps.  The yardsticks are
the port's loop and the plain reference: nothing here is compared with the
JAX package."""

import collections
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.reference import model as ref
from tests.test_torch_compiled import _stand_in_capture
from tputopo_torch import _graphs, _kernels
from tputopo_torch import model as tm
from tputopo_torch import moe as tmoe
from tputopo_torch import obs
from tputopo_torch import quant as tq
from tputopo_torch import serving as ts

torch.set_num_threads(1)

D, F_, E, K = 32, 48, 8, 2
CFG = tm.ModelConfig(vocab_size=64, d_model=D, n_layers=2, n_heads=4, n_kv_heads=2,
                     d_ff=F_, max_seq=64, compute_dtype=torch.float32,
                     moe=tmoe.MoEConfig(n_experts=E, top_k=K))
BF16 = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
# The plain reference reads the sizes from a configuration file's keys.
REF_MODEL = {"num_local_experts": E, "num_experts_per_tok": K, "router_aux_loss_coef": 0.0}
# float32: the same products summed in other orders.
F32_TOL = 2e-5
# bfloat16: the routed layer rounds the gathered rows, both products and the
# SiLU gate to bf16 (8 significant bits, a relative step of 2^-8) where the
# loop keeps them in float32 against the same bf16-rounded weights; four
# roundings in a row, each up to half a step, stay within 1.5% of the
# largest output, held at 2%.
BF16_REL = 2e-2


def _layer(seed=0):
    p = tmoe.init_moe_params(dataclasses.replace(CFG, n_layers=1), seed, device="cpu")
    return {k: v[0] for k, v in p.items()}


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _biased(p, x, towards=0, never=7):
    """The router tilted along x's common direction: every token's first
    choice is ``towards``, and ``never`` is never chosen."""
    p = dict(p)
    v = x.reshape(-1, D).mean(0)
    r = p["router"].clone()
    r[:, towards] += 40.0 * v / v.norm() ** 2
    r[:, never] -= 40.0 * v / v.norm() ** 2
    p["router"] = r
    return p


def _cases():
    """(name, x, layer): one token; a prefill width; few tokens over many
    experts, so that most experts get no pair; a router biased so that one
    expert takes a pair of every token and another none."""
    p = _layer()
    x_bias = _x((2, 16, D), 5) + 2.0
    return [("T1", _x((1, 1, D)), p), ("prefill", _x((2, 24, D), 2), p),
            ("few_tokens", _x((1, 2, D), 3), p), ("biased", x_bias, _biased(p, x_bias))]


CASES = {name: (x, p) for name, x, p in _cases()}


def _routes(x, p):
    gates, idx = tmoe._top_k_gates(x.reshape(-1, D).float(), p["router"], CFG.moe)
    return idx


@pytest.mark.parametrize("case", list(CASES))
def test_routed_layer_equals_the_loop_and_the_plain_reference_in_float32(case):
    x, p = CASES[case]
    got = tmoe.moe_mlp_routed(x, p, CFG)
    loop = tmoe.moe_mlp_reference(x, p, CFG)
    plain, _ = ref.experts(x, p, REF_MODEL, low=False, seated=False)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert (got - loop).abs().max() <= F32_TOL
    assert (got - plain).abs().max() <= F32_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_routed_layer_in_bfloat16_within_its_stated_tolerance(case):
    x, p = CASES[case]
    xb = x.bfloat16()
    got = tmoe.moe_mlp_routed(xb, p, BF16).float()
    loop = tmoe.moe_mlp_reference(xb, p, BF16).float()
    plain, _ = ref.experts(xb.float(), p, REF_MODEL, low=False, seated=False)
    assert got.dtype == torch.float32
    scale = plain.abs().max()
    assert (got - loop).abs().max() <= BF16_REL * scale
    assert (got - plain).abs().max() <= BF16_REL * scale


def test_the_cases_cover_empty_experts_and_a_dominant_one():
    hit_few = torch.bincount(_routes(*CASES["few_tokens"]).flatten(), minlength=E)
    assert (hit_few == 0).sum() >= E - 4
    idx = _routes(*CASES["biased"])
    load = torch.bincount(idx.flatten(), minlength=E)
    assert (idx == 0).any(-1).all() and load[0] == idx.shape[0] and load[7] == 0
    assert load[0] == load.max() and (load[1:] < load[0]).all()


@pytest.mark.parametrize("ends", [[3, 3, 7, 7, 7, 10], [0, 0, 0, 0, 0, 10], [10] * 6])
def test_grouped_mm_twin_multiplies_each_segment_by_its_table(ends):
    a, b = _x((10, 6)), _x((6, 6, 5), 2)
    got = tmoe.grouped_mm(a, b, torch.tensor(ends, dtype=torch.int32))
    lo = 0
    for g, hi in enumerate(ends):
        assert torch.equal(got[lo:hi], a[lo:hi] @ b[g])
        lo = hi


def test_routed_layer_is_taken_on_cuda_bf16_raw_tables_only():
    """The rule in plain objects (no CUDA tensor can be made here): the
    CPU, a float32 compute dtype and quantized tables keep the loop."""
    class FakeCuda:
        device = torch.device("cuda", 0)

    p = _layer()
    q = tq.quantize_params(tm.init_params(CFG, 0, device="cpu"), bits=8)["layers"]["moe"]
    assert tq.is_quantized(q["w_gate"])
    assert tmoe.routed_takes(FakeCuda, p, BF16)
    assert not tmoe.routed_takes(FakeCuda, p, CFG)
    assert not tmoe.routed_takes(FakeCuda, q, BF16)
    assert not tmoe.routed_takes(_x((1, 1, D)), p, BF16)


def _engine_rows(params, cfg, **kw):
    rng = np.random.default_rng(4)
    eng = ts.ServingEngine(params, cfg, slots=2, max_len=40, prompt_pad=(8, 16),
                           prefill_chunk=8, **kw)
    ids = [eng.submit(rng.integers(0, 64, n).tolist(), max_new=m)
           for n, m in ((5, 6), (14, 4), (3, 7), (9, 5))]
    res = eng.run()
    return [list(res[i]) for i in ids], eng


@pytest.fixture(scope="module")
def weights():
    return tm.init_params(CFG, 0, device="cpu")


@pytest.fixture
def routed(monkeypatch):
    """Every MoE layer of serving through the routed layer, as on CUDA."""
    monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, cfg: True)


def test_engine_tokens_through_the_routed_layer_equal_the_loops(weights, monkeypatch):
    loop, _ = _engine_rows(weights, CFG)
    calls = []
    body = tmoe.moe_mlp_routed
    monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, cfg: True)
    monkeypatch.setattr(tmoe, "moe_mlp_routed",
                        lambda *a, **kw: calls.append(a[0].shape) or body(*a, **kw))
    got, _ = _engine_rows(weights, CFG)
    assert got == loop
    assert len(calls) % CFG.n_layers == 0 and {s[1] for s in calls} >= {1, 8}


def _recording(monkeypatch):
    """Every routing of the layer, recorded: the expert ids [N, k]."""
    seen = []
    gates = tmoe._top_k_gates

    def record(x32, router, m):
        out = gates(x32, router, m)
        seen.append(out[1].clone())
        return out

    monkeypatch.setattr(tmoe, "_top_k_gates", record)
    return seen


def _recount(seen):
    loads = [torch.bincount(i.flatten(), minlength=E) for i in seen]
    pairs = sum(int(i.numel()) for i in seen)
    return {"calls": len(seen), "pairs": pairs,
            "experts_hit": sum(int((c > 0).sum()) for c in loads),
            "max_load": sum(int(c.max()) for c in loads), "pairs_all": pairs,
            "device_ns": 0}


def test_traced_counts_equal_a_host_recount_of_the_routing(weights, routed, monkeypatch):
    seen = _recording(monkeypatch)
    rows, eng = _engine_rows(weights, CFG, tracer=obs.Tracer())
    out = eng.tracer.export()
    assert seen and out["moe"] == _recount(seen)
    assert out["grouped_mm"] == {"launches": 0}  # the CPU twin launches nothing
    untraced, plain = _engine_rows(weights, CFG)
    assert rows == untraced and plain.expert_counts is None


def test_replayed_programs_count_every_replay(weights, routed, monkeypatch):
    """With stand-in graphs (a replay re-runs the captured body), the counts
    add up every replay's routing; an engine traced after its captures
    recaptures, the counts' storage being part of the key."""
    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)
    seen = _recording(monkeypatch)
    rows, eng = _engine_rows(weights, CFG, tracer=obs.Tracer())
    assert eng.programs.replays["decode_step"] > 1
    assert eng.tracer.export()["moe"] == _recount(seen)
    loop, late = _engine_rows(weights, CFG)
    captured = sum(late.programs.captures.values())
    late.tracer = obs.Tracer()
    seen.clear()
    rng = np.random.default_rng(4)
    late.submit(rng.integers(0, 64, 5).tolist(), max_new=6)
    late.run()
    assert sum(late.programs.captures.values()) > captured
    assert late.tracer.export()["moe"] == _recount(seen)
    assert rows == loop


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_untraced_layer_adds_no_operation(monkeypatch):
    x, p = CASES["prefill"]
    with _Ops() as plain:
        tmoe.moe_mlp_routed(x, p, CFG)
    counts = tmoe.ExpertCounts("cpu")
    with tmoe.counting(counts), _Ops() as traced:
        tmoe.moe_mlp_routed(x, p, CFG)
    assert len(traced.ops) > len(plain.ops)
    assert not collections.Counter(plain.ops) - collections.Counter(traced.ops)
    monkeypatch.setattr(tmoe.ExpertCounts, "add", lambda *a: pytest.fail("counted"))
    monkeypatch.setattr(tmoe.ExpertCounts, "clock", lambda *a: pytest.fail("timed"))
    tmoe.moe_mlp_routed(x, p, CFG)


def test_device_clock_c_signature_matches_its_argtypes():
    k = _kernels.DEVICE_CLOCK
    m = re.search(r'extern "C" int (tputopo_\w+)\(([^)]*)\)', k.source.read_text())
    kinds = ["pointer" if "*" in d else d.split()[0] for d in m.group(2).split(",")]
    want = {"c_void_p": "pointer", "c_int": "int", "c_float": "float"}
    assert m.group(1) == k.symbol
    assert kinds == [want[t.__name__] for t in k.argtypes]
    assert k not in _kernels.KERNELS and _kernels.GROUPED_MM in _kernels.COUNTED


def _harness_model():
    """A tiny Mixtral in the benchmark's layout: its configuration keys, its
    weights (``perfbench.harness.weights``) and the port's config in f32."""
    from perfbench.harness.port import model_config
    from perfbench.harness.weights import make

    m = {"hidden_size": D, "intermediate_size": F_, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
         "vocab_size": 64, "max_position_embeddings": 64, "rope_theta": 1e4,
         "rms_norm_eps": 1e-5, "num_local_experts": E, "num_experts_per_tok": K,
         "router_aux_loss_coef": 0.0, "capacity_factor": 1.25}
    cfg = dataclasses.replace(model_config(m), compute_dtype=torch.float32)
    return m, make(m, 3, torch.device("cpu")), cfg


@pytest.mark.parametrize("layer", ["loop", "routed"])
def test_engine_keeps_the_expert_choices_of_each_finished_request(layer, monkeypatch):
    """Every position a request fed through the layers holds the experts
    the layer chose there: replayed into the plain reference, they are the
    reference's own top k and give its greedy tokens back."""
    from perfbench.reference import routed as ref_routed

    if layer == "routed":
        monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, cfg: True)
    m, params, cfg = _harness_model()
    rng = np.random.default_rng(6)
    eng = ts.ServingEngine(params, cfg, slots=2, max_len=48, prompt_pad=(8, 16),
                           prefill_chunk=8, record_routes=True)
    lens = {eng.submit(rng.integers(0, 64, n).tolist(), max_new=k): n
            for n, k in ((5, 6), (14, 4), (3, 7), (16, 3))}
    res = eng.run()
    assert sorted(eng.routes) == sorted(lens)
    for rid, n in lens.items():
        row, routes = res[rid], eng.routes[rid]
        assert routes.shape == (m["num_hidden_layers"], len(row) - 1, K)
        assert routes.dtype == torch.int16 and (routes >= 0).all()
        logits, gap = ref_routed.logits_at(params, torch.tensor(row[:-1]), m,
                                           torch.arange(n - 1, len(row) - 1), routes.long())
        assert gap <= 1e-6
        assert logits.argmax(-1).tolist() == row[n:]
    plain = ts.ServingEngine(params, cfg, slots=2, max_len=48, prompt_pad=(8, 16),
                             prefill_chunk=8)
    assert plain.state.cache.routes is None and not plain.routes


def test_routes_are_kept_for_an_expert_config_only():
    with pytest.raises(ValueError, match="MoE"):
        ts.init_state(dataclasses.replace(CFG, moe=None), 2, 16, device="cpu",
                      record_routes=True)
