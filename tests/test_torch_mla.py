"""DeepSeek-V3's blocks in the port at a tiny size on the CPU: multi-head
latent attention over the latent cache (both forms), YaRN RoPE, the
group-limited sigmoid router, the shared expert and a held share of the
routed experts, the leading dense layers; prefill and decode through the
cached layers and through ``ServingEngine``.  The yardstick is the
benchmark's plain reference, ``perfbench/reference/deepseek.py`` (torch
only), with the harness's weights (``perfbench/harness/deepseek.py``);
nothing here is compared with the JAX package, which has no latent
attention."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import deepseek as ds
from perfbench.reference import deepseek as ref
from tests.test_torch_compiled import _stand_in_capture
from tputopo_torch import _graphs, attention, decode, mla, obs
from tputopo_torch import model as tm
from tputopo_torch import moe as tmoe
from tputopo_torch import quant as tq
from tputopo_torch import serving as ts

torch.set_num_threads(1)

# hidden 64, 4 heads, ranks 32/16, nope/rope/v 8/4/8, 16 experts in 4 groups,
# top-2 groups, top-4, 1 shared, 1 dense + 2 expert layers, 4 experts held.
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 4, "v_head_dim": 8, "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 32,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1},
        "rms_norm_eps": 1e-6, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "intermediate_size": 96, "moe_intermediate_size": 32, "n_shared_experts": 1,
        "router_experts": 16, "n_routed_experts": 4, "experts_held": [4, 8],
        "n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
        "routed_scaling_factor": 2.5, "norm_topk_prob": True, "scoring_func": "sigmoid",
        "topk_method": "noaux_tc", "vocab_size": 128, "max_position_embeddings": 512,
        "router_bias_std": 0.05}
CFG = dataclasses.replace(ds.model_config(TINY), compute_dtype=torch.float32)
BF16 = ds.model_config(TINY)
# float32 on both sides: the same products, summed in other orders (the
# absorbed form contracts q with W_uk before the cache rows, the reference
# after): a few float32 ulps of logits of size ~4.
F32_TOL = 5e-5
# bfloat16: the served token's reference logit below the reference's best,
# at the program's expert choices.  Every activation of the program is
# rounded to bf16 (2^-9), through 3 layers at width 64; the logits spread
# ~5 between best and worst, so a wrong token reads ~1 or more.
BF16_GAP = 0.25


@pytest.fixture(scope="module")
def params():
    return ds.make(TINY, 7, torch.device("cpu"))


def _port_logits(params, cfg, tokens, prefill):
    """The port's logits at every position of ``tokens`` [T]: the first
    ``prefill`` through one block (the expanded form), the rest one decode
    step each (the absorbed form); and the expert choices it kept."""
    T = tokens.shape[0]
    cache = decode.KVCache.create(cfg, 1, T + 4, device="cpu", routes=True)
    cos, sin = tm._rope_tables(cfg, T + 4, "cpu")
    out = [decode._block_step(params, cfg, tokens[None, :prefill], 0, cache, cos, sin)[0]]
    for i in range(prefill, T):
        out.append(decode._block_step(params, cfg, tokens[None, i:i + 1], i, cache,
                                      cos, sin)[0])
    return torch.cat(out).float(), cache.routes[:, 0, :T].long()


def test_prefill_then_decode_matches_the_reference_at_f32(params):
    tokens = torch.randint(0, 128, (40,), generator=torch.Generator().manual_seed(1))
    port, routes = _port_logits(params, CFG, tokens, 28)
    want = torch.arange(40)
    free, _ = ref.logits_at(params, tokens, TINY, want)
    replayed, gap = ref.logits_at(params, tokens, TINY, want, routes=routes)
    assert gap == 0.0  # the same choices in float32
    assert (port - replayed).abs().max() <= F32_TOL
    assert (port - free).abs().max() <= F32_TOL


def test_engine_bf16_tokens_lie_at_the_reference_best(params, monkeypatch):
    """Prefill in chunks, then decode, through ``ServingEngine`` at bf16 with
    the routed layer taken as on the card: every served token's reference
    logit, at the program's choices, within :data:`BF16_GAP` of the best."""
    monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, cfg: True)
    eng = ts.ServingEngine(params, BF16, slots=3, max_len=64, prompt_pad=(16, 32),
                           prefill_chunk=16, record_routes=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, n).tolist() for n in (9, 30, 17, 25)]
    rids = [eng.submit(p, 8) for p in prompts]
    res = eng.run()
    for rid, prompt in zip(rids, prompts):
        row = res[rid]
        seq, want = torch.tensor(row[:-1]), torch.arange(len(prompt) - 1, len(row) - 1)
        logits, rgap = ref.logits_at(params, seq, TINY, want, routes=eng.routes[rid].long())
        served = torch.tensor(row[len(prompt):])
        gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
        assert gap.max() <= BF16_GAP
        assert rgap <= 0.1


def _latent_inputs(B=2, T=6, S=20, seed=0):
    m = CFG.mla
    g = torch.Generator().manual_seed(seed)
    N = CFG.n_heads
    q_nope = torch.randn(B, T, N, m.nope, generator=g)
    q_pe = torch.randn(B, T, N, m.rope, generator=g)
    latent = torch.randn(B, S, m.row, generator=g)
    kv_b = torch.randn(m.kv_rank, N * (m.nope + m.v), generator=g) / 4
    pos = torch.tensor([3, S - T])[:B]
    return q_nope, q_pe, latent, pos, kv_b, m


def _naive(q_nope, q_pe, latent, pos, kv_b, m):
    """Every head's keys and values up-projected, one softmax over the whole
    masked cache."""
    B, T, N, _ = q_nope.shape
    S = latent.shape[1]
    kv = (latent[..., :m.kv_rank] @ kv_b).reshape(B, S, N, m.nope + m.v)
    k = torch.cat([kv[..., :m.nope], latent[:, :, None, m.kv_rank:].expand(-1, -1, N, -1)], -1)
    q = torch.cat([q_nope, q_pe], -1)
    s = torch.einsum("btnd,bsnd->bnts", q, k) * mla.softmax_scale(m)
    qpos = pos[:, None] + torch.arange(T)
    s = s.masked_fill(torch.arange(S)[None, None, None, :] > qpos[:, None, :, None],
                      float("-inf"))
    return torch.einsum("bnts,bsnv->btnv", torch.softmax(s, -1), kv[..., m.nope:])


@pytest.mark.parametrize("T", [1, 6])
def test_absorbed_and_expanded_forms_agree(T, monkeypatch):
    """The two forms and a naive softmax over the whole cache, at f32 (the
    absorbed form's blocks shrunk so that its online softmax runs over
    several)."""
    monkeypatch.setattr(attention, "LATENT_BLOCK", 8)
    monkeypatch.setattr(attention, "LATENT_EXPANDED_BLOCK", 8)
    args = _latent_inputs(T=T)
    a = attention.latent_absorbed(*args)
    e = attention.latent_expanded(*args)
    n = _naive(*args)
    assert (a - n).abs().max() <= 1e-5 and (e - n).abs().max() <= 1e-5


def test_the_form_follows_the_query_count(monkeypatch):
    taken = []
    for name in ("latent_absorbed", "latent_expanded"):
        form = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, form=form, name=name: taken.append(name) or form(*a))
    for T in (1, attention.LATENT_ABSORBED_T, attention.LATENT_ABSORBED_T + 1):
        args = _latent_inputs(B=1, T=T, S=40)
        attention.cached_latent_attention(*args)
    assert taken == ["latent_absorbed", "latent_absorbed", "latent_expanded"]


def test_yarn_tables_and_scale_follow_the_formulas():
    m = mla.MLAConfig.deepseek_v3()
    # DeepSeek-V3: the ramp runs from dim 10 to 23 of the 32 frequencies
    assert mla.yarn_ramp(m, 10000.0) == (10, 23)
    assert math.isclose(mla.softmax_scale(m), 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2)
    cos, sin = mla.rope_tables(m, 10000.0, 4096, "cpu")
    i = np.arange(32)
    base = 10000.0 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    freq = base / 40 * ramp + base * (1 - ramp)
    ang = np.arange(4096)[:, None] * freq[None]
    assert np.allclose(cos.numpy(), np.cos(ang), atol=2e-3)
    assert np.allclose(sin.numpy(), np.sin(ang), atol=2e-3)
    # the reference's tables, in float64 then f32, on the tiny model's YaRN
    c_ref, s_ref = ref.rope_tables(TINY, 64, "cpu")
    c, s = tm._rope_tables(CFG, 64, "cpu")
    assert (c - c_ref).abs().max() <= 1e-5 and (s - s_ref).abs().max() <= 1e-5


def test_rope_rotates_adjacent_pairs():
    x = torch.randn(1, 3, 2, 4)
    cos, sin = mla.rope_tables(CFG.mla, 10000.0, 3, "cpu")
    y = mla.rope_pairs(x, cos, sin)
    pair = torch.complex(x[..., 0::2], x[..., 1::2]) * torch.polar(
        torch.ones_like(cos), torch.atan2(sin, cos))[None, :, None, :]
    assert torch.allclose(y[..., 0::2], pair.real, atol=1e-6)
    assert torch.allclose(y[..., 1::2], pair.imag, atol=1e-6)


def _router_loop(x, router, bias, m):
    """DeepSeek-V3's gate written token by token from the report."""
    gates, ids = [], []
    per = m.n_experts // m.n_group
    for t in range(x.shape[0]):
        s = [1 / (1 + math.exp(-float(x[t] @ router[:, e]))) for e in range(m.n_experts)]
        c = [s[e] + float(bias[e]) for e in range(m.n_experts)]
        groups = [sum(sorted(c[g * per:(g + 1) * per])[-2:]) for g in range(m.n_group)]
        keep = sorted(range(m.n_group), key=lambda g: -groups[g])[:m.topk_group]
        cand = [e for e in range(m.n_experts) if e // per in keep]
        top = sorted(cand, key=lambda e: -c[e])[:m.top_k]
        w = [s[e] for e in top]
        gates.append([v / sum(w) * m.routed_scale for v in w])
        ids.append(top)
    return torch.tensor(gates), torch.tensor(ids)


def test_router_matches_a_loop_from_the_paper(params):
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(12, 64, generator=torch.Generator().manual_seed(4))
    gates, ids = tmoe.route(x, p, CFG.moe)
    want_g, want_ids = _router_loop(x, p["router"], p["bias"], CFG.moe)
    order = ids.argsort(-1)
    assert torch.equal(ids.gather(1, order), want_ids.sort(-1).values)
    assert torch.allclose(gates.gather(1, order),
                          want_g.gather(1, want_ids.argsort(-1)), atol=1e-6)
    assert torch.equal(ref.choose(torch.sigmoid(x @ p["router"]), p["bias"], TINY).sort(-1).values,
                       want_ids.sort(-1).values)


@pytest.mark.parametrize("layer", ["loop", "routed"])
def test_four_shares_add_up_to_the_uncut_layer(layer, params, monkeypatch):
    """The share test: the 16 experts held in 4 shares of 4, as 4 chips of
    EP4 hold them; each share's partial output (its own experts' pairs and
    the shared expert) summed over the shares, with the shared expert
    counted once, is the uncut layer's (all 16 held).  On the port's layer
    (the loop, and the routed layer as on the card) and on the reference's."""
    if layer == "routed":
        monkeypatch.setattr(tmoe, "routed_takes", lambda x, p, cfg: True)
    g = torch.Generator().manual_seed(9)
    D, Fe, E = 64, 32, 16
    tables = {n: torch.randn((E, D, Fe) if n != "w_down" else (E, Fe, D), generator=g) / 8
              for n in ("w_gate", "w_up", "w_down")}
    base = {k: v[0] for k, v in params["layers"]["moe"].items()
            if k not in ("w_gate", "w_up", "w_down")}
    x = torch.randn(1, 10, D, generator=g)

    def port(lo, hi):
        cfg = dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, held=(lo, hi)))
        p = dict(base, **{n: t[lo:hi] for n, t in tables.items()})
        return decode.serving_ffn(x, {"moe": p}, cfg)

    def reference(lo, hi):
        m = dict(TINY, experts_held=[lo, hi])
        p = dict(base, **{n: t[lo:hi] for n, t in tables.items()})
        return ref.experts(x[0], p, m, False)[0]

    for side in (port, reference):
        parts = [side(lo, lo + 4) for lo in range(0, E, 4)]
        shared = ref.swiglu(x[0] if side is reference else x, base["shared_gate"],
                            base["shared_up"], base["shared_down"], False)
        whole = side(0, E)
        assert (sum(parts) - 3 * shared - whole).abs().max() <= 1e-4


def test_routes_above_127_are_kept_and_read_back(monkeypatch):
    """256 router outputs (DeepSeek-V3's count) with the bias pushing the
    choice to the last group: the kept ids, all above 127, are the
    router's own."""
    m = dict(TINY, router_experts=256, n_group=8, topk_group=4, experts_held=[0, 4],
             router_bias_std=0.0)
    cfg = dataclasses.replace(ds.model_config(m), compute_dtype=torch.float32)
    params = ds.make(m, 11, torch.device("cpu"))
    params["layers"]["moe"]["bias"][:, 224:] = 10.0  # the last group wins every choice
    seen = []
    route = tmoe.route
    monkeypatch.setattr(tmoe, "route",
                        lambda x32, p, mm: seen.append(route(x32, p, mm)[1]) or route(x32, p, mm))
    eng = ts.ServingEngine(params, cfg, slots=1, max_len=32, prompt_pad=(8,),
                           record_routes=True)
    rid = eng.submit(list(range(5)), 3)
    eng.run()
    kept = eng.routes[rid]
    assert kept.dtype == torch.int16 and kept.shape == (2, 7, 4)
    assert (kept >= 224).all()
    # the prefill's choices of the first expert layer, as the router made them
    assert torch.equal(kept[0, :5].sort(-1).values.long(), seen[0].reshape(-1, 4)[:5].sort(-1).values)


def test_traced_engine_counts_latent_rows_and_pairs(params):
    """The ``mla`` counts of a traced engine against a recount from the
    requests' lengths: each prefill call attends its block's positions, each
    decode step one new position over the row so far."""
    eng = ts.ServingEngine(params, CFG, slots=2, max_len=48, prompt_pad=(32,),
                           tracer=obs.Tracer())
    for n, k in ((5, 4), (12, 3)):
        eng.submit(list(range(1, 1 + n)), k)
    eng.run()
    c = eng.tracer.export()["mla"]
    L = CFG.n_layers
    # admissions: one 32-wide block a request at start 0
    assert c["prefill_calls"] == 2 * L and c["prefill_queries"] == 2 * 32 * L
    assert c["prefill_rows"] == 2 * 32 * L and c["prefill_pairs"] == 2 * (32 * 33 // 2) * L
    # decode: request (5, 4) feeds positions 5, 6, 7; (12, 3) feeds 12, 13
    steps = [5, 6, 7, 12, 13]
    assert c["decode_queries"] == len(steps) * L
    assert c["decode_rows"] == c["decode_pairs"] == sum(p + 1 for p in steps) * L
    assert c["calls"] == c["decode_calls"] + c["prefill_calls"] and c["device_ns"] == 0


def test_replayed_programs_count_the_latent_calls_of_every_replay(params, monkeypatch):
    """Stand-in graphs (a replay re-runs the captured body): the latent
    counts grow with every replay (and with a capture's warm-up, which runs
    the body once more), a layer's worth at a time."""
    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)
    eng = ts.ServingEngine(params, CFG, slots=2, max_len=48, prompt_pad=(32,),
                           tracer=obs.Tracer())
    for n in (5, 9, 3):
        eng.submit(list(range(1, 1 + n)), 4)
    eng.run()
    c = eng.tracer.export()["mla"]
    L = CFG.n_layers
    assert c["prefill_calls"] % L == 0 and c["prefill_calls"] >= 3 * L
    assert c["decode_calls"] % L == 0 and c["decode_calls"] > 0


def test_cache_kernels_never_take_a_latent_cache():
    """``decode_attn`` and ``chunk_attn`` take [B, S, KV, H] caches only: a
    latent cache slice [B, S, kv_rank + rope] is refused even where every
    other condition holds (CUDA, bf16)."""
    class Cuda:
        def __init__(self, *shape):
            self.shape, self.dtype = shape, torch.bfloat16
            self.device = torch.device("cuda")

        def dim(self):
            return len(self.shape)

    q, latent = Cuda(2, 1, 128, 128), Cuda(2, 4096, 576)
    assert not attention.decode_kernel_takes(q, latent, None, 128)
    assert not attention.chunk_kernel_takes(q, latent, None, 128)
    gqa = Cuda(2, 4096, 8, 128)
    assert attention.decode_kernel_takes(Cuda(2, 1, 32, 128), gqa, None, 4)


def test_latent_cache_layout():
    cache = decode.KVCache.create(BF16, 3, 40, device="cpu", routes=True)
    assert cache.k is None and cache.v is None
    assert cache.latent.shape == (3, 3, 40, 20) and cache.latent.dtype == torch.bfloat16
    assert cache.routes.shape == (2, 3, 40, 4) and cache.routes.dtype == torch.int16
    assert cache.positions == 40
    with pytest.raises(ValueError, match="head widths"):
        BF16.head_dim


def test_resident_copy_holds_every_latent_and_expert_weight(params):
    tree = tq.compute_params(params, torch.bfloat16)
    layers = tree["layers"]
    for name in ("q_a", "q_b", "kv_a", "kv_b", "wo", "w_gate", "w_up", "w_down"):
        assert layers[name].dtype == torch.bfloat16
    for name in ("w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down"):
        assert layers["moe"][name].dtype == torch.bfloat16
    for name in ("q_a_norm", "kv_a_norm", "attn_norm"):
        assert layers[name] is params["layers"][name]
    assert layers["moe"]["router"] is params["layers"]["moe"]["router"]
    assert layers["moe"]["bias"] is params["layers"]["moe"]["bias"]


@pytest.mark.parametrize("path", ["int8_cache", "speculative_engine", "spec_generate",
                                  "lora", "quantized", "training_forward"])
def test_paths_without_latent_attention_refuse_it(path, params):
    from tputopo_torch import lora, speculative

    with pytest.raises(ValueError, match="MLA|latent"):
        if path == "int8_cache":
            decode.KVCache.create(dataclasses.replace(BF16, kv_dtype="int8"), 1, 8,
                                  device="cpu")
        elif path == "speculative_engine":
            speculative.SpecServingEngine(params, CFG, slots=1, max_len=32,
                                          prompt_pad=8, draft_layers=1)
        elif path == "spec_generate":
            speculative.spec_generate(params, torch.zeros(1, 4, dtype=torch.long), CFG,
                                      max_new=2, draft_layers=1)
        elif path == "lora":
            lora.init_lora(CFG, 0, rank=2, device="cpu")
        elif path == "quantized":
            tq.quantize_params(params)
        else:
            tm.forward(params, torch.zeros(1, 4, dtype=torch.long), CFG)


def test_training_forward_refuses_deepseeks_expert_layout():
    cfg = dataclasses.replace(CFG, mla=None, n_kv_heads=2)
    with pytest.raises(ValueError, match="Mixtral's expert layer only"):
        tm.forward({}, torch.zeros(1, 4, dtype=torch.long), cfg)


@pytest.mark.parametrize("T", [1, attention.LATENT_ABSORBED_T + 4])
def test_a_span_bounds_the_rows_read(T, monkeypatch):
    """A chunk whose end is known when its program is built (``span``): each
    form reads no row at or past it (those rows hold NaN here) and leaves
    the blocks every query attends unmasked, and still equals the naive
    softmax over the whole cache (blocks shrunk so that the span cuts a
    block and several lie below its unmasked bound)."""
    monkeypatch.setattr(attention, "LATENT_BLOCK", 8)
    monkeypatch.setattr(attention, "LATENT_EXPANDED_BLOCK", 8)
    q_nope, q_pe, latent, _, kv_b, m = _latent_inputs(B=1, T=T, S=64)
    pos = torch.tensor([37 - T])
    want = _naive(q_nope, q_pe, latent, pos, kv_b, m)
    poisoned = latent.clone()
    poisoned[:, 37:] = float("nan")
    got = attention.cached_latent_attention(q_nope, q_pe, poisoned, pos, kv_b, m, span=37)
    assert (got - want).abs().max() <= 1e-5


def _chunk_captures(cfg, params, monkeypatch):
    """The prefill programs' captures of an engine that prefills prompts of
    20 and 28 tokens in chunks of 8 (starts 0, 8, 16 and the final chunks
    at 16 and 24), with stand-in graphs."""
    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)
    eng = ts.ServingEngine(params, cfg, slots=2, max_len=48, prompt_pad=(32,),
                           prefill_chunk=8)
    for n in (20, 28):
        eng.submit(list(range(1, 1 + n)), 2)
    eng.run()
    got = eng.programs.counts()["captures"]
    return got.get("prefill_chunk", 0), got.get("admit_final_chunk", 0)


def test_latent_chunk_programs_are_one_per_chunk_end(params, monkeypatch):
    """An MLA config's chunk programs are captured per chunk end (the span
    latent attention reads up to), a GQA config's per chunk width only."""
    assert _chunk_captures(CFG, params, monkeypatch) == (3, 2)
    gqa = dataclasses.replace(tm.ModelConfig(vocab_size=128, d_model=32, n_layers=1,
                                             n_heads=4, n_kv_heads=2, d_ff=48),
                              compute_dtype=torch.float32)
    dense = tm.init_params(gqa, seed=0, device="cpu")
    assert _chunk_captures(gqa, dense, monkeypatch) == (1, 1)
