"""The port's speculative decoding (tputopo_torch.speculative) against the
JAX package's, on the reference's own tiny f32 config (vocab 64, d_model
32, 4 layers): the same converted parameters and seeded prompts go to
both sides.  Greedy speculation is lossless, so at f32 the port's tokens
must equal JAX's and the port's own greedy ``generate`` token for token,
and its accounting (target steps, drafted tokens accepted, the serving
engine's metrics) must equal JAX's exactly — for raw, int8 and int4 trees,
for random (worst-case) drafts, at the budget edges, through EOS early
exit and the max_len frontier, and over randomized schedules."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import model as jm
from tputopo.workloads import quant as jq
from tputopo.workloads import speculative as js
from tputopo_torch import decode as td
from tputopo_torch import lora as tl
from tputopo_torch import model as tm
from tputopo_torch import quant as tq
from tputopo_torch import speculative as ts

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=96)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
CFGS = {"bf16": (JCFG, TCFG),
        "int8": (dataclasses.replace(JCFG, kv_dtype="int8"),
                 dataclasses.replace(TCFG, kv_dtype="int8"))}


@pytest.fixture(scope="module")
def weights():
    """{"raw" | "int8" | "int4": (JAX tree, the port's tree)}, each side
    quantized by its own package (bit-exact, see test_torch_quant.py)."""
    jp = jm.init_params(JCFG, jax.random.key(0))
    tp = to_torch(jp)
    return {"raw": (jp, tp),
            "int8": (jq.quantize_params(jp), tq.quantize_params(tp)),
            "int4": (jq.quantize_params(jp, bits=4, group_size=16),
                     tq.quantize_params(tp, bits=4, group_size=16))}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (1, n))


def _both_generate(weights, prompt, max_new, w="raw", kv="bf16", **kw):
    """spec_generate on both sides and the port's greedy generate ->
    (JAX tokens, JAX stats, port tokens, port stats, port greedy)."""
    (jp, tp), (jcfg, tcfg) = weights[w], CFGS[kv]
    jtok, jst = js.spec_generate(jp, jnp.asarray(prompt), jcfg, max_new=max_new, **kw)
    ttok, tst = ts.spec_generate(tp, torch.from_numpy(prompt), tcfg, max_new=max_new,
                                 **kw)
    greedy = td.generate(tp, torch.from_numpy(prompt), tcfg, max_new=max_new)
    return (np.asarray(jtok), {k: int(v) for k, v in jst.items()}, ttok.numpy(), tst,
            greedy.numpy())


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_acceptance_row_matches_jax(gamma):
    """Random rows, plus the all-agree and none-agree rows: the commit row
    and the first disagreement equal JAX's (argmin over bool, ties to the
    first index)."""
    rng = np.random.default_rng(gamma)
    B = 32
    targets = rng.integers(0, 3, (B, gamma + 1))
    drafts = np.where(rng.random((B, gamma)) < 0.6, targets[:, :gamma],
                      rng.integers(0, 3, (B, gamma)))
    drafts[0] = targets[0, :gamma]          # every draft agrees
    drafts[1] = (targets[1, :gamma] + 1) % 3  # none does
    jrow, jn = js._acceptance_row(jnp.asarray(drafts), jnp.asarray(targets))
    trow, tn = ts._acceptance_row(torch.from_numpy(drafts), torch.from_numpy(targets))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn[0] == gamma and tn[1] == 0


@pytest.mark.parametrize("draft_layers", [1, 2])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_spec_generate_matches_jax_and_greedy(weights, gamma, draft_layers):
    jtok, jst, ttok, tst, greedy = _both_generate(
        weights, _prompt(1, 7), 12, draft_layers=draft_layers, gamma=gamma)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(ttok, greedy)
    assert tst == jst
    assert tst["target_steps"] + tst["drafted_accepted"] in (12, 13)


@pytest.mark.parametrize("w", ["int8", "int4"])
def test_quantized_spec_generate_matches_jax_and_greedy(weights, w):
    """The draft slice on {int8, scale} and grouped int4 leaves, over int8
    KV caches, against the quantized tree's own greedy decode."""
    jtok, jst, ttok, tst, greedy = _both_generate(
        weights, _prompt(3, 6), 8, w=w, kv="int8", draft_layers=2, gamma=3)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(ttok, greedy)
    assert tst == jst


@pytest.mark.parametrize("max_new", [1, 2])
def test_budget_edges(weights, max_new):
    """max_new below gamma: commits are capped at the budget."""
    jtok, jst, ttok, tst, greedy = _both_generate(
        weights, _prompt(4, 5), max_new, draft_layers=1, gamma=5)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(ttok, greedy)
    assert tst == jst


def test_draft_slice_is_views_of_the_same_tree(weights):
    """A depth slice of raw, int8, int4 and LoRA-wrapped leaves: shapes cut
    to the draft's depth, storage shared with the target's tensors; the
    embed and head are the target's own."""
    lora = tl.init_lora(TCFG, 3, rank=2, device="cpu")
    trees = {w: weights[w][1] for w in ("raw", "int8", "int4")}
    trees["lora_int4"] = tl.lora_view(weights["int4"][1], lora)
    for name, tree in trees.items():
        dp, dc = ts.draft_slice(tree, TCFG, 2)
        assert dc.n_layers == 2 and dc.d_model == TCFG.d_model
        assert dp["embed"] is tree["embed"] and dp["lm_head"] is tree["lm_head"]

        def check(full, cut):
            if isinstance(full, dict):
                assert set(full) == set(cut)
                for k in full:
                    check(full[k], cut[k])
            else:
                assert cut.shape == (2, *full.shape[1:]), name
                assert cut.data_ptr() == full.data_ptr(), name

        check(tree["layers"], dp["layers"])
    with pytest.raises(ValueError, match="draft_layers"):
        ts.draft_slice(weights["raw"][1], TCFG, 0)
    with pytest.raises(ValueError, match="draft_layers"):
        ts.draft_slice(weights["raw"][1], TCFG, TCFG.n_layers)
    with pytest.raises(ValueError, match="single-sequence"):
        ts.spec_generate(weights["raw"][1], torch.zeros((2, 4), dtype=torch.long), TCFG,
                         max_new=2, draft_layers=1)
    with pytest.raises(ValueError, match="max_new"):
        ts.spec_generate(weights["raw"][1], torch.zeros((1, 4), dtype=torch.long), TCFG,
                         max_new=0, draft_layers=1)


def test_lora_wrapped_spec_generate_matches_jax():
    """The draft slice of a LoRA-wrapped tree (the adapter's layer axis cut
    with the base's), with a nonzero adapter carried across from JAX."""
    from tputopo.workloads import lora as jl
    from tputopo_torch.convert import lora_from_numpy

    jp = jm.init_params(JCFG, jax.random.key(0))
    lora = jl.init_lora(JCFG, jax.random.key(1), rank=4)
    lora["layers"]["wq"]["b"] = jax.random.normal(
        jax.random.key(2), lora["layers"]["wq"]["b"].shape) * 0.02
    tlora = lora_from_numpy(jax.tree.map(np.asarray, lora), device="cpu")
    prompt = _prompt(6, 6)
    jtok, _ = js.spec_generate(jl.lora_view(jp, lora), jnp.asarray(prompt), JCFG,
                               max_new=8, draft_layers=2, gamma=3)
    tview = tl.lora_view(to_torch(jp), tlora)
    ttok, _ = ts.spec_generate(tview, torch.from_numpy(prompt), TCFG, max_new=8,
                               draft_layers=2, gamma=3)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    greedy = td.generate(tview, torch.from_numpy(prompt), TCFG, max_new=8)
    assert torch.equal(ttok, greedy)


# ---- speculative continuous batching ----------------------------------------

def _engine_stream(engine, lens, news, seed, w="raw", kv="bf16", eos_from=None):
    return dict(engine=engine, lens=lens, news=news, seed=seed, w=w, kv=kv,
                eos_from=eos_from)


def _random_stream(seed):
    """The reference's randomized schedule (tests/test_speculative.py)."""
    rng = np.random.default_rng(200 + seed)
    slots, gamma = int(rng.integers(1, 4)), int(rng.integers(1, 5))
    draft_layers = int(rng.integers(1, BASE["n_layers"]))
    n_req = int(rng.integers(3, 7))
    lens = tuple(int(rng.integers(1, 7)) for _ in range(n_req))
    news = tuple(int(rng.integers(1, 8)) for _ in range(n_req))
    return _engine_stream(dict(slots=slots, max_len=20, prompt_pad=6,
                               draft_layers=draft_layers, gamma=gamma),
                          lens, news, 300 + seed)


ENGINE_STREAMS = {
    # ragged prompts, mid-stream admission and slot reuse
    "ragged": _engine_stream(dict(slots=2, max_len=24, prompt_pad=6, draft_layers=2,
                                  gamma=3), (3, 6, 2, 5, 4), (6, 4, 7, 3, 5), 40),
    # EOS inside an accepted run stops the slot there
    "eos": _engine_stream(dict(slots=2, max_len=24, prompt_pad=4, draft_layers=1,
                               gamma=4), (4, 4, 4, 4), 10, 41, eos_from=10),
    "accounting": _engine_stream(dict(slots=3, max_len=24, prompt_pad=4,
                                      draft_layers=3, gamma=2), (4, 4, 4), 6, 43),
    # a budget that fills the logical buffer: the verify window runs into
    # the gamma+1 margin and must not clamp
    "max_len_frontier": _engine_stream(dict(slots=1, max_len=16, prompt_pad=6,
                                            draft_layers=2, gamma=4), (6,), 10, 44),
    "int8_stack": _engine_stream(dict(slots=2, max_len=24, prompt_pad=5, draft_layers=2,
                                      gamma=2), (3, 5, 2), 5, 42, w="int8", kv="int8"),
    "int4_weights": _engine_stream(dict(slots=2, max_len=24, prompt_pad=5,
                                        draft_layers=1, gamma=3), (5, 2, 4), 5, 45,
                                   w="int4"),
    **{f"random_{s}": _random_stream(s) for s in range(4)},
}


@pytest.mark.parametrize("name", sorted(ENGINE_STREAMS))
def test_spec_engine_matches_jax(weights, name):
    """Per request: the port's tokens equal JAX's and the port's one-shot
    greedy decode; engine metrics (decode_steps = target streams,
    drafted_accepted, admissions) equal JAX's."""
    st = ENGINE_STREAMS[name]
    (jp, tp), (jcfg, tcfg) = weights[st["w"]], CFGS[st["kv"]]
    rng = np.random.default_rng(st["seed"])
    prompts = [rng.integers(0, BASE["vocab_size"], (n,)).tolist() for n in st["lens"]]
    news = (st["news"] if isinstance(st["news"], tuple)
            else (st["news"],) * len(prompts))
    refs = [td.generate(tp, torch.tensor([p]), tcfg, max_new=m)[0].tolist()
            for p, m in zip(prompts, news)]
    eos = -1
    if st["eos_from"] is not None:  # an id the greedy streams emit mid-way
        gen = [t for p, r in zip(prompts, refs) for t in r[len(p):]]
        eos = gen[len(gen) // 2]
    je = js.SpecServingEngine(jp, jcfg, eos_id=eos, **st["engine"])
    te = ts.SpecServingEngine(tp, tcfg, eos_id=eos, **st["engine"])
    jids = [je.submit(p, max_new=m) for p, m in zip(prompts, news)]
    tids = [te.submit(p, max_new=m) for p, m in zip(prompts, news)]
    jres, tres = je.run(), te.run()
    stopped = 0
    for ji, ti, p, ref in zip(jids, tids, prompts, refs):
        gen = ref[len(p):]
        cut = gen.index(eos) + 1 if eos in gen else len(gen)
        assert tres[ti] == jres[ji] == p + gen[:cut], (name, ti)
        stopped += cut < len(gen)
    assert te.metrics == je.metrics
    if st["eos_from"] is not None:
        assert stopped >= 1, "the stream did not exercise EOS"
    emitted = sum(len(tres[i]) - len(p) for i, p in zip(tids, prompts))
    assert 0 <= te.metrics["drafted_accepted"] <= emitted


def test_spec_engine_rejects_prefix_and_bad_gamma(weights):
    tp = weights["raw"][1]
    eng = ts.SpecServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=4,
                               draft_layers=1)
    with pytest.raises(ValueError, match="prefix caching"):
        eng.submit([1, 2], max_new=2, prefix=0)
    with pytest.raises(ValueError, match="gamma"):
        ts.SpecServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=4,
                             draft_layers=1, gamma=0)
    with pytest.raises(ValueError, match="draft_layers"):
        ts.SpecServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=4,
                             draft_layers=4)


def test_spec_engine_streams_its_commits(weights):
    """on_tokens fires with every committed token, in order, once."""
    tp = weights["raw"][1]
    got: dict[int, list[int]] = {}
    eng = ts.SpecServingEngine(tp, TCFG, slots=2, max_len=24, prompt_pad=6,
                               draft_layers=2, gamma=3,
                               on_tokens=lambda rid, toks: got.setdefault(rid, []).extend(toks))
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]
    ids = [eng.submit(p, max_new=6) for p in prompts]
    res = eng.run()
    for rid, p in zip(ids, prompts):
        assert got[rid] == res[rid][len(p):]
