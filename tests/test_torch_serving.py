"""The port's continuous-batching engine (tputopo_torch.serving) against the
JAX package's: on the same request stream, at f32, the port's
``ServingEngine`` must give the JAX ``ServingEngine``'s tokens for every
request exactly, and the same engine metrics — plain, ragged, bucketed,
chunked, prefix-cached, int8 KV and quantized weights, mirroring
``tests/test_serving.py`` and the engine tests of ``tests/test_quant.py``.
Added beside them: a mid-prefill slot's first chunk surviving interleaved
decode ticks (the junk-write redirect), and ``_write_kv_at``'s start
clamp against JAX's ``dynamic_update_slice``.

Not mirrored, and why:

- the compile-count tests: the port traces nothing, so there is no
  program cache to count;
- MoE serving: held against the JAX engine in tests/test_torch_moe.py;
- sharded serving: it comes with the multi-GPU slice;
- the speculative engine's stream: it comes with ``speculative.py``'s
  slice.

Sampling draws from a ``torch.Generator``, whose stream JAX's PRNG cannot
reproduce, so only its contract is checked."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import model as jm
from tputopo.workloads import quant as jq
from tputopo.workloads import serving as js
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import quant as tq
from tputopo_torch import serving as ts

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
CFGS = {"bf16": (JCFG, TCFG),
        "int8": (dataclasses.replace(JCFG, kv_dtype="int8"),
                 dataclasses.replace(TCFG, kv_dtype="int8"))}


@pytest.fixture(scope="module")
def weights():
    """{"raw" | "int8" | "int4": (JAX tree, the port's tree)}; the
    quantized trees are quantized on each side (bit-exact, see
    test_torch_quant.py)."""
    jp = jm.init_params(JCFG, jax.random.key(0))
    tp = to_torch(jp)
    return {"raw": (jp, tp),
            "int8": (jq.quantize_params(jp), tq.quantize_params(tp)),
            "int4": (jq.quantize_params(jp, bits=4, group_size=16),
                     tq.quantize_params(tp, bits=4, group_size=16))}


def _serve(eng, requests, prefixes=()):
    """Register ``prefixes``, submit ``requests`` ((prompt, max_new, prefix
    index or None), ...), run -> the result rows in submission order."""
    pids = [eng.register_prefix(p) for p in prefixes]
    ids = [eng.submit(p, max_new=m, prefix=None if x is None else pids[x])
           for p, m, x in requests]
    res = eng.run()
    return [res[i] for i in ids]


def _both(weights, requests, prefixes=(), *, w="raw", kv="bf16", **kw):
    """The same stream through the JAX engine and the port's -> (JAX rows,
    port rows, JAX engine, port engine)."""
    (jp, tp), (jcfg, tcfg) = weights[w], CFGS[kv]
    je = js.ServingEngine(jp, jcfg, **kw)
    te = ts.ServingEngine(tp, tcfg, **kw)
    return (_serve(je, requests, prefixes), _serve(te, requests, prefixes),
            je, te)


def _prompts(seed, lens, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def _stream(engine, lens, news, seed, w="raw", kv="bf16", prefix=0,
            n_prefixed=0):
    """One mirrored stream: engine kwargs, prompt lengths, max_new (one for
    all or one per request), the prompts' seed, the weights, the cache
    dtype, and a prefix length with the number of leading requests that
    use it."""
    return dict(engine=engine, lens=lens, news=news, seed=seed, w=w, kv=kv,
                prefix=prefix, n_prefixed=n_prefixed)


STREAMS = {
    "uniform": _stream(dict(slots=3, max_len=16, prompt_pad=5), (5, 5, 5), 6, 0),
    "ragged": _stream(dict(slots=4, max_len=24, prompt_pad=8), (2, 5, 8, 3), 5, 1),
    "mid_stream_admission": _stream(dict(slots=2, max_len=16, prompt_pad=6),
                                    (3, 6, 2, 5, 4, 6, 3, 2),
                                    (4, 7, 3, 6, 5, 4, 7, 3), 3),
    "steps_per_tick": _stream(dict(slots=2, max_len=20, prompt_pad=5,
                                   steps_per_tick=4), (2, 5, 3, 4), 6, 6),
    "budget_one": _stream(dict(slots=1, max_len=8, prompt_pad=4), (3,), 1, 7),
    "bucketed": _stream(dict(slots=2, max_len=20, prompt_pad=(4, 8)),
                        (2, 3, 7, 8, 4, 2), 4, 10),
    "chunked_whole_bucket": _stream(dict(slots=2, max_len=20, prompt_pad=8,
                                         prefill_chunk=2), (8, 3, 6, 8, 5), 4, 12),
    "chunked_int8_kv": _stream(dict(slots=2, max_len=20, prompt_pad=8,
                                    prefill_chunk=4), (8, 4), 4, 15, kv="int8"),
    "int8_kv": _stream(dict(slots=2, max_len=24, prompt_pad=5), (5, 3, 4), 6, 11,
                       kv="int8"),
    "int8_weights": _stream(dict(slots=2, max_len=24, prompt_pad=5), (5, 3), 6, 7,
                            w="int8"),
    "int4_weights": _stream(dict(slots=2, max_len=24, prompt_pad=(4, 8),
                                 prefill_chunk=4), (5, 3, 8), 5, 8, w="int4"),
    "prefix": _stream(dict(slots=2, max_len=32, prompt_pad=8), (3, 5, 2, 7, 4),
                      (5, 5, 5, 5, 3), 20, prefix=6, n_prefixed=4),
    "prefix_chunked_suffix": _stream(dict(slots=2, max_len=32, prompt_pad=8,
                                          prefill_chunk=4), (7, 8, 1), 4, 21,
                                     prefix=5, n_prefixed=3),
    "prefix_int8_kv": _stream(dict(slots=1, max_len=32, prompt_pad=8), (4,), 5, 22,
                              kv="int8", prefix=6, n_prefixed=1),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_jax_engine(weights, name):
    s = STREAMS[name]
    lens, news = s["lens"], s["news"]
    news = [news] * len(lens) if isinstance(news, int) else list(news)
    prefixes = _prompts(s["seed"] + 100, (s["prefix"],)) if s["prefix"] else ()
    requests = [(p, m, 0 if i < s["n_prefixed"] else None)
                for i, (p, m) in enumerate(zip(_prompts(s["seed"], lens), news))]
    ref, out, je, te = _both(weights, requests, prefixes, w=s["w"], kv=s["kv"],
                             **s["engine"])
    assert out == ref
    assert te.metrics == je.metrics
    assert te.metrics["finished"] == len(requests)
    assert te.metrics["prefix_admits"] == s["n_prefixed"]


def test_eos_stops_a_sequence_early(weights):
    """An EOS id taken from the middle of the generated tokens stops some
    sequences there (EOS included), on both engines alike."""
    prompts = _prompts(2, (4, 4, 4, 4))
    requests = [(p, 12, None) for p in prompts]
    kw = dict(slots=2, max_len=24, prompt_pad=4)
    free = _serve(ts.ServingEngine(weights["raw"][1], TCFG, **kw), requests)
    gen = [t for p, r in zip(prompts, free) for t in r[len(p):]]
    eos = gen[len(gen) // 2]
    ref, out, _, _ = _both(weights, requests, eos_id=eos, **kw)
    assert out == ref
    assert any(len(r) < len(f) for r, f in zip(out, free))
    for r, f in zip(out, free):
        assert r == f[:len(r)] and (len(r) == len(f) or r[-1] == eos)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_schedules_match_jax_engine(weights, seed):
    """tests/test_serving.py's property test: any mix of prompt lengths,
    budgets, slot counts, tick chunking, buckets and prefill chunks."""
    rng = np.random.default_rng(100 + seed)
    slots = int(rng.integers(1, 4))
    steps_per_tick = int(rng.integers(1, 5))
    buckets = (4, 8) if rng.integers(2) else 8
    prefill_chunk = [None, 2, 4][int(rng.integers(3))]
    n_req = int(rng.integers(4, 9))
    prompts = [rng.integers(0, 64, (int(rng.integers(1, 9)),)).tolist()
               for _ in range(n_req)]
    news = [int(rng.integers(1, 7)) for _ in range(n_req)]
    ref, out, je, te = _both(
        weights, [(p, m, None) for p, m in zip(prompts, news)], slots=slots,
        max_len=16, prompt_pad=buckets, steps_per_tick=steps_per_tick,
        prefill_chunk=prefill_chunk)
    assert out == ref, (slots, steps_per_tick, buckets, prefill_chunk)
    assert te.metrics == je.metrics


def _drive_interleaved(engine_cls, params, cfg, short, long_p):
    """tests/test_serving.py's hand-driven interleaving: a short request
    decodes while a long one prefills in chunks."""
    eng = engine_cls(params, cfg, slots=2, max_len=24, prompt_pad=8,
                     prefill_chunk=2)
    i_short = eng.submit(short, max_new=10)
    eng.step()
    i_long = eng.submit(long_p, max_new=4)
    before = eng.metrics["decode_steps"]
    eng.step()  # the long prompt's first chunk; the short one decodes
    prefilling = bool(eng._prefilling)
    decoded = eng.metrics["decode_steps"] > before
    res = eng.run()
    return res[i_short], res[i_long], prefilling, decoded


def test_chunked_prefill_interleaves_with_decode(weights):
    (jp, tp) = weights["raw"]
    short, long_p = _prompts(13, (2, 8))
    ref = _drive_interleaved(js.ServingEngine, jp, JCFG, short, long_p)
    out = _drive_interleaved(ts.ServingEngine, tp, TCFG, short, long_p)
    assert out == ref
    assert out[2] and out[3], "decode must proceed during a chunked prefill"


def test_chunked_prefill_skips_tail_chunks(weights):
    """A prompt of 5 in an 8-bucket with chunk 2 runs ceil(5/2) = 3 chunks."""
    ref, out, _, te = _both(weights, [(_prompts(14, (5,))[0], 3, None)],
                            slots=1, max_len=16, prompt_pad=8, prefill_chunk=2)
    assert out == ref
    assert te.metrics["prefill_chunks"] == 3


def test_junk_writes_spare_a_prefilling_slots_first_chunk(weights):
    """While a long prompt prefills chunk by chunk, the other slot's decode
    ticks run the idle lane too, and its junk K/V must land at max_len-1,
    not on the chunk already in the prefilling slot's cache.  Positions
    0..1 hold chunk 0's K/V, which depend on tokens 0..1 alone: they must
    equal a standalone prefill of those two tokens after every tick."""
    _, tp = weights["raw"]
    short, long_p = _prompts(40, (2, 8))
    eng = ts.ServingEngine(tp, TCFG, slots=2, max_len=24, prompt_pad=8,
                           prefill_chunk=2)
    eng.submit(short, max_new=10)
    eng.step()  # short admitted into slot 0
    eng.submit(long_p, max_new=4)
    want = ts.build_prefix_cache(tp, TCFG, torch.tensor(long_p[:2]))
    ticks = 0
    while eng._prefilling or not ticks:
        before = eng.metrics["decode_steps"]
        eng.step()
        ticks += eng.metrics["decode_steps"] > before
        for got, ref in zip(eng.state.cache[:2], want[:2]):
            np.testing.assert_allclose(got[:, 1, :2].numpy(), ref[:, 0].numpy(),
                                       rtol=1e-6, atol=1e-6)
    assert ticks >= 3  # decode ticks ran while slot 1 held a partial prompt


@pytest.mark.parametrize("starts", [[0, 3, 5], [-2, 6, 7], [7, 100, 4],
                                    [-1, -3, -9]])
def test_write_kv_at_clamps_like_jax(starts):
    """``dynamic_update_slice`` counts a negative start once from the end,
    then clamps it into [0, S - T]; the port's indexed write does the same
    (S = 8, T = 3)."""
    rng = np.random.default_rng(41)
    cache = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    kv = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    pos = np.asarray(starts, np.int32)
    ref = np.asarray(js._write_kv_at(jnp.asarray(cache), jnp.asarray(kv),
                                     jnp.asarray(pos)))
    out = torch.from_numpy(cache.copy())
    td._write_kv_at(out, torch.from_numpy(kv), torch.from_numpy(pos).long())
    np.testing.assert_array_equal(out.numpy(), ref)


def _prefilled(params, cfg, prompts, max_len):
    """A batch cache with each row prefilled by its own prompt (lengths may
    differ) through the port's block step."""
    cos, sin = tm._rope_tables(cfg, max_len, "cpu")
    cache = td.KVCache.create(cfg, len(prompts), max_len, device="cpu")
    for b, p in enumerate(prompts):
        td._block_step(params, cfg, torch.tensor([p]), 0,
                       ts._slot_cache(cache, b), cos, sin)
    return cache


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_ragged_block_matches_block_step_and_jax(weights, kv):
    """At uniform positions the ragged block equals the batch block step
    (logits and cache), and its logits equal JAX's ragged_block."""
    (jp, tp), (jcfg, tcfg) = weights["raw"], CFGS[kv]
    B, T, max_len, start = 3, 4, 32, 5
    seed = _prompts(31, (5, 5, 5))
    toks = np.random.default_rng(30).integers(0, 64, (B, T))
    cache_a = _prefilled(tp, tcfg, seed, max_len)
    cache_b = td.KVCache(*(None if b is None else b.clone() for b in cache_a))
    cos, sin = tm._rope_tables(tcfg, max_len, "cpu")
    lg_a = td._block_step(tp, tcfg, torch.from_numpy(toks), start, cache_a, cos, sin)
    lg_b = ts.ragged_block(tp, tcfg, torch.from_numpy(toks),
                           torch.full((B,), start), cache_b)
    np.testing.assert_allclose(lg_b.numpy(), lg_a.numpy(), rtol=2e-5, atol=2e-5)
    for a, b in zip(cache_a, cache_b):
        if a is not None:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-5)

    jcos, jsin = jm._rope_tables(jcfg, max_len)
    _, jcache = jd._block_step(jp, jcfg, jnp.asarray(seed), 0,
                               jd.KVCache.create(jcfg, B, max_len), jcos, jsin)
    ref, _ = js.ragged_block(jp, jcfg, jnp.asarray(toks),
                             jnp.full((B,), start, jnp.int32), jcache)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_ragged_block_per_slot_positions_match_independent_runs(weights):
    """At DIFFERENT per-slot positions each slot's logits equal a batch-1
    run of the same tokens at that position."""
    _, tp = weights["raw"]
    starts, T, max_len = [4, 7, 2], 3, 32
    prefixes = _prompts(32, starts)
    toks = torch.from_numpy(np.random.default_rng(33).integers(0, 64, (3, T)))
    cache = _prefilled(tp, TCFG, prefixes, max_len)
    lg = ts.ragged_block(tp, TCFG, toks, torch.tensor(starts), cache)
    cos, sin = tm._rope_tables(TCFG, max_len, "cpu")
    for b, s in enumerate(starts):
        one = _prefilled(tp, TCFG, [prefixes[b]], max_len)
        lg1 = td._block_step(tp, TCFG, toks[b:b + 1], s, one, cos, sin)
        np.testing.assert_allclose(lg[b].numpy(), lg1[0].numpy(), rtol=2e-5, atol=2e-5)


def test_streaming_callback_reconstructs_results(weights):
    """on_tokens streams exactly the generated tail of every request, in
    order, across ragged prompts, chunked prefill and slot reuse."""
    _, tp = weights["raw"]
    prompts = _prompts(60, (3, 6, 2, 5))
    news = [6, 4, 7, 3]
    streamed: dict[int, list[int]] = {}

    def on_tokens(rid, toks):
        assert toks, "empty emission"
        streamed.setdefault(rid, []).extend(toks)

    eng = ts.ServingEngine(tp, TCFG, slots=2, max_len=24, prompt_pad=(4, 8),
                           prefill_chunk=4, on_tokens=on_tokens)
    ids = [eng.submit(p, max_new=m) for p, m in zip(prompts, news)]
    results = eng.run()
    for rid, p in zip(ids, prompts):
        assert streamed[rid] == results[rid][len(p):], rid
    ref, _, _, _ = _both(weights, [(p, m, None) for p, m in zip(prompts, news)],
                         slots=2, max_len=24, prompt_pad=(4, 8), prefill_chunk=4)
    assert [results[i] for i in ids] == ref


def test_sampling_terminates_and_repeats_under_one_seed(weights):
    _, tp = weights["raw"]

    def run(seed):
        eng = ts.ServingEngine(tp, TCFG, slots=2, max_len=16, prompt_pad=4,
                               temperature=0.8, top_k=8,
                               generator=torch.Generator().manual_seed(seed))
        return _serve(eng, [([1, 2, 3], 5, None)] * 3)

    a, b = run(7), run(7)
    assert a == b
    for r in a:
        assert len(r) == 3 + 5 and r[:3] == [1, 2, 3]
        assert all(0 <= t < 64 for t in r)
    with pytest.raises(ValueError, match="torch.Generator"):
        ts.ServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=4,
                         temperature=0.8)


def test_engine_validation(weights):
    _, tp = weights["raw"]
    eng = ts.ServingEngine(tp, TCFG, slots=1, max_len=8, prompt_pad=4)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([1] * 9, max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1], max_new=0)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1] * 4, max_new=5)  # 4 + 5 > 8
    with pytest.raises(ValueError, match="prompt_pad"):
        ts.ServingEngine(tp, TCFG, slots=1, max_len=4, prompt_pad=4)
    with pytest.raises(ValueError, match="bad prompt_pad"):
        ts.ServingEngine(tp, TCFG, slots=1, max_len=8, prompt_pad=())
    with pytest.raises(ValueError, match="steps_per_tick"):
        ts.ServingEngine(tp, TCFG, slots=1, max_len=8, prompt_pad=4,
                         steps_per_tick=0)
    for chunk in (3, 0):  # 3 does not divide 8
        with pytest.raises(ValueError, match="prefill_chunk"):
            ts.ServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=8,
                             prefill_chunk=chunk)
    # MoE serving is ported (tests/test_torch_moe.py): the engine takes an
    # MoE tree
    from tputopo_torch.moe import MoEConfig

    moe_cfg = dataclasses.replace(TCFG, moe=MoEConfig(n_experts=2))
    eng = ts.ServingEngine(tm.init_params(moe_cfg, 0, device="cpu"), moe_cfg, slots=1,
                           max_len=8, prompt_pad=4)
    eng.submit([1, 2], max_new=2)
    row = list(eng.run()[0])
    assert row[:2] == [1, 2] and len(row) == 4  # the prompt, then 2 new tokens


def test_prefix_cache_validation_and_unregister(weights):
    _, tp = weights["raw"]
    eng = ts.ServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=8)
    with pytest.raises(ValueError, match="non-empty"):
        eng.register_prefix([])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.register_prefix([1] * 12)  # 12 + bucket 8 > 16
    pid = eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit([4], max_new=2, prefix=pid + 999)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([4] * 8, max_new=8, prefix=pid)  # 3 + 8 + 8 > 16
    rid = eng.submit([1, 2], max_new=2, prefix=pid)
    with pytest.raises(ValueError, match="still referenced"):
        eng.unregister_prefix(pid)
    assert rid in eng.run()
    eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit([1], max_new=2, prefix=pid)


def test_state_invariants_empty():
    st = ts.init_state(TCFG, slots=3, max_len=8, device="cpu")
    assert not bool(st.active.any())
    assert st.seq_id.tolist() == [-1, -1, -1]
    assert st.cache.k.shape == (2, 3, 8, 2, 8) and st.cache.k_scale is None
    st8 = ts.init_state(CFGS["int8"][1], slots=2, max_len=8, device="cpu")
    assert st8.cache.k.dtype == torch.int8 and st8.cache.k_scale.shape == (2, 2, 8, 2, 1)
