"""The serving engine's weights held at the compute dtype (``quant.compute_params``,
``serving.resident_params``), on the CPU at a tiny size: which leaves the copy
converts and which it shares, across raw, int8, int4, LoRA-wrapped and expert
trees; that an engine serving from the copy computes bit for bit what one
casting on every call computes (tokens, a decode step's logits, the expert
choices, a prefix admission, the speculative engine); the fit rule that falls
back to per-call casts; and the ``weights`` record a tracer carries.  The
yardstick is the port's own per-call cast: nothing here is compared with the
JAX package."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tputopo_torch import _graphs, lora, obs
from tputopo_torch import model as tm
from tputopo_torch import moe as tmoe
from tputopo_torch import quant as tq
from tputopo_torch import serving as ts
from tputopo_torch import speculative as tsv

torch.set_num_threads(1)

BF16 = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_ff=48, max_seq=64, compute_dtype=torch.bfloat16)
MOE = dataclasses.replace(BF16, moe=tmoe.MoEConfig(n_experts=4, top_k=2))
ENGINE = dict(slots=2, max_len=40, prompt_pad=(8, 16), prefill_chunk=8)
# The names of the weights every serving consumer casts whole to the compute
# dtype before use.
CAST = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head", "lora_base"}


def _flat(tree, prefix=""):
    """Dotted path -> tensor (non-tensor leaves, a LoRA scale, left out)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif torch.is_tensor(v):
            out[prefix + k] = v
    return out


def _trees():
    dense = tm.init_params(BF16, 0, device="cpu")
    adapter = lora.init_lora(BF16, 1, rank=4, device="cpu")
    return {"raw": (dense, BF16),
            "int8": (tq.quantize_params(dense, bits=8), BF16),
            "int4": (tq.quantize_params(dense, bits=4, group_size=16), BF16),
            "lora": (lora.lora_view(dense, adapter), BF16),
            "qlora_int8": (lora.lora_view(tq.quantize_params(dense, bits=8), adapter), BF16),
            "moe": (tm.init_params(MOE, 0, device="cpu"), MOE),
            "f32_compute": (dense, dataclasses.replace(BF16, compute_dtype=torch.float32))}


TREES = _trees()


@pytest.mark.parametrize("case", sorted(TREES))
def test_compute_params_converts_exactly_the_cast_weights(case):
    params, cfg = TREES[case]
    dt = cfg.compute_dtype
    before = _flat(params)
    got = _flat(tq.compute_params(params, dt))
    assert got.keys() == before.keys()
    converted = {p for p in before if got[p] is not before[p]}
    want = {p for p, t in before.items()
            if p.split(".")[-1] in CAST and t.dtype != dt}
    assert converted == want
    for p in converted:
        assert got[p].dtype == dt and got[p].is_contiguous()
        assert got[p].shape == before[p].shape
        assert torch.equal(got[p], before[p].to(dt))
    after = _flat(params)  # the input tree is left as it was
    assert all(after[p] is before[p] for p in before)
    assert tq.compute_bytes(params, dt) == sum(got[p].nbytes for p in converted)
    expected = {"raw": 8, "int8": 0, "int4": 0, "lora": 8, "qlora_int8": 0, "moe": 8,
                "f32_compute": 0}
    assert len(converted) == expected[case]


def test_compute_params_keeps_the_router_norms_and_embedding_f32():
    params, cfg = TREES["moe"]
    got = tq.compute_params(params, cfg.compute_dtype)
    for path in ("layers.moe.router", "layers.attn_norm", "layers.mlp_norm",
                 "final_norm", "embed"):
        assert _flat(got)[path] is _flat(params)[path]
        assert _flat(got)[path].dtype == torch.float32
    assert {p for p in _flat(got) if _flat(got)[p].dtype == torch.bfloat16} == {
        "layers.wq", "layers.wk", "layers.wv", "layers.wo", "layers.moe.w_gate",
        "layers.moe.w_up", "layers.moe.w_down", "lm_head"}


def _requests(seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, n).tolist(), m)
            for n, m in ((5, 6), (14, 4), (3, 7), (9, 5))]


def _serve(params, cfg, *, cls=ts.ServingEngine, prefix=None, **kw):
    """The requests through an engine -> (rows, the engine); with
    ``prefix``, every other request behind it."""
    eng = cls(params, cfg, **kw)
    pid = eng.register_prefix(prefix) if prefix else None
    ids = [eng.submit(p, max_new=m, prefix=pid if prefix and i % 2 == 0 else None)
           for i, (p, m) in enumerate(_requests())]
    res = eng.run()
    return [res[i] for i in ids], eng


ENGINES = {
    "dense": (BF16, ts.ServingEngine, {}, ENGINE),
    "moe_routes": (MOE, ts.ServingEngine, {}, dict(ENGINE, record_routes=True)),
    "moe_routed_layer": (MOE, ts.ServingEngine, {"routed": True},
                         dict(ENGINE, record_routes=True)),
    "prefix": (BF16, ts.ServingEngine, {"prefix": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]}, ENGINE),
    "lora": (BF16, ts.ServingEngine, {"lora": True}, ENGINE),
    "speculative": (BF16, tsv.SpecServingEngine, {},
                    dict(slots=2, max_len=40, prompt_pad=(8, 16), draft_layers=1,
                         gamma=2)),
}


def _engine_case(name, monkeypatch):
    cfg, cls, opts, kw = ENGINES[name]
    params = tm.init_params(cfg, 0, device="cpu")
    if opts.get("lora"):
        adapter = lora.init_lora(cfg, 1, rank=4, device="cpu")
        gen = torch.Generator().manual_seed(2)
        for ad in adapter["layers"].values():
            ad["b"].normal_(0.0, 0.02, generator=gen)
        params = lora.lora_view(params, adapter)
    if opts.get("routed"):
        monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, c: True)
    return params, cfg, cls, opts.get("prefix"), kw


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_served_tokens_are_bitwise_those_of_per_call_casts(name, monkeypatch):
    params, cfg, cls, prefix, kw = _engine_case(name, monkeypatch)
    rows, eng = _serve(params, cfg, cls=cls, prefix=prefix, **kw)
    assert eng.weights["resident"] == 1 and eng.weights["leaves"] > 0
    assert eng.params is not params
    with monkeypatch.context() as m:
        m.setattr(ts, "_free_bytes", lambda device: 0)
        cast_rows, cast_eng = _serve(params, cfg, cls=cls, prefix=prefix, **kw)
    assert cast_eng.weights == {"resident": 0, "bytes": 0, "leaves": 0}
    assert cast_eng.params is params
    assert rows == cast_rows
    assert eng.metrics == cast_eng.metrics
    if kw.get("record_routes"):
        assert eng.routes.keys() == cast_eng.routes.keys()
        for rid in eng.routes:
            assert torch.equal(eng.routes[rid], cast_eng.routes[rid])


def test_the_speculative_draft_is_a_view_of_the_resident_copy():
    params = tm.init_params(BF16, 0, device="cpu")
    _, kw = ENGINES["speculative"][2:]
    eng = tsv.SpecServingEngine(params, BF16, **kw)
    held, draft = _flat(eng.params), _flat(eng.draft_params)
    assert draft.keys() == held.keys()
    for path, t in draft.items():
        assert t.untyped_storage().data_ptr() == held[path].untyped_storage().data_ptr()
        assert t.dtype == held[path].dtype
    assert draft["layers.wq"].dtype == torch.bfloat16
    assert draft["layers.wq"].shape[0] == kw["draft_layers"]


def _prefilled_state(params, cfg):
    """A state with two slots admitted, mid-way through their answers."""
    state = ts.init_state(cfg, 2, 32, device="cpu")
    for slot, (prompt, _) in enumerate(_requests()[:2]):
        padded = torch.zeros(16, dtype=torch.long)
        padded[:len(prompt)] = torch.tensor(prompt)
        ts.admit(params, state, cfg, slot, padded, len(prompt), slot, 8, -1)
    ts.decode_step(params, state, cfg, -1)
    return state


@pytest.mark.parametrize("cfg", [BF16, MOE], ids=["dense", "moe"])
def test_one_decode_steps_logits_are_bitwise_those_of_per_call_casts(cfg):
    params = tm.init_params(cfg, 0, device="cpu")
    copy = tq.compute_params(params, cfg.compute_dtype)
    state = _prefilled_state(params, cfg)
    pos = state.length - 1
    tok = state.tokens.gather(1, pos[:, None])
    caches = [ts.KVCache(*(None if b is None else b.clone() for b in state.cache))
              for _ in range(2)]
    cast = ts.ragged_block(params, cfg, tok, pos, caches[0])
    held = ts.ragged_block(copy, cfg, tok, pos, caches[1])
    assert torch.equal(cast, held)
    for a, b in zip(*caches):
        assert a is None or torch.equal(a, b)


class _WeightCasts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the f32 -> bf16 copies whose input lies in a master's storage."""

    def __init__(self, params):
        super().__init__()
        self.storages = {t.untyped_storage().data_ptr() for t in _graphs.tensors(params)}
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func is torch.ops.aten._to_copy.default and args[0].dtype == torch.float32
                and out.dtype == torch.bfloat16
                and args[0].untyped_storage().data_ptr() in self.storages):
            self.n += 1
        return out


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "masters"])
def test_a_decode_step_casts_no_weight_when_resident(resident, monkeypatch):
    """Per-call casts: one a projection a layer and the head's; resident:
    none."""
    if not resident:
        monkeypatch.setattr(ts, "_free_bytes", lambda device: 0)
    params = tm.init_params(BF16, 0, device="cpu")
    eng = ts.ServingEngine(params, BF16, **ENGINE)
    eng.submit(_requests()[0][0], max_new=4)
    eng.step()
    with _WeightCasts(params) as casts:
        eng._decode_tick()
    assert casts.n == (0 if resident else 7 * BF16.n_layers + 1)


def test_the_fit_rule_counts_the_copy_the_states_clone_and_the_headroom(monkeypatch):
    params = tm.init_params(BF16, 0, device="cpu")
    need = tq.compute_bytes(params, torch.bfloat16)
    state = ts.init_state(BF16, ENGINE["slots"], ENGINE["max_len"], device="cpu")
    clone = sum(t.nbytes for t in _graphs.tensors(state))
    edge = need + clone + ts.RESIDENT_HEADROOM
    seen = []

    def reading(free):
        def read(device):
            seen.append(device)
            return free
        return read

    monkeypatch.setattr(ts, "_free_bytes", reading(edge))
    assert ts.ServingEngine(params, BF16, **ENGINE).weights["resident"] == 1
    monkeypatch.setattr(ts, "_free_bytes", reading(edge - 1))
    assert ts.ServingEngine(params, BF16, **ENGINE).weights["resident"] == 0
    assert seen == [torch.device("cpu")] * 2
    monkeypatch.undo()
    assert ts._free_bytes(torch.device("cpu")) is None  # the CPU sets no limit


def test_nothing_to_convert_is_resident_whatever_the_free_memory(monkeypatch):
    monkeypatch.setattr(ts, "_free_bytes", lambda device: 0)
    params, cfg = TREES["int8"]
    eng = ts.ServingEngine(params, cfg, **ENGINE)
    assert eng.weights == {"resident": 1, "bytes": 0, "leaves": 0}


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "masters"])
def test_the_tracer_carries_the_weights_record(resident, monkeypatch):
    if not resident:
        monkeypatch.setattr(ts, "_free_bytes", lambda device: 0)
    params = tm.init_params(MOE, 0, device="cpu")
    tracer = obs.Tracer()
    rows, eng = _serve(params, MOE, tracer=tracer, **ENGINE)
    out = tracer.export()
    want = ({"resident": 1, "bytes": tq.compute_bytes(params, torch.bfloat16), "leaves": 8}
            if resident else {"resident": 0, "bytes": 0, "leaves": 0})
    assert out["weights"] == want == eng.weights
    assert want["bytes"] == sum(t.nbytes for p, t in _flat(eng.params).items()
                                if t.dtype == torch.bfloat16)


def test_a_dropped_traced_engine_frees_its_copy_without_the_collector():
    """The tracer outlives the engine: the engine's copy goes with the
    engine, and the tracer still exports what it carried."""
    params = tm.init_params(BF16, 0, device="cpu")
    tracer = obs.Tracer()
    rows, eng = _serve(params, BF16, tracer=tracer, **ENGINE)
    copy = weakref.ref(eng.params["lm_head"])
    assert copy() is not params["lm_head"]
    gc.disable()
    try:
        del eng
        assert copy() is None
    finally:
        gc.enable()
    out = tracer.export()
    assert out["weights"]["resident"] == 1 and out["engine"]["finished"] == len(rows)
