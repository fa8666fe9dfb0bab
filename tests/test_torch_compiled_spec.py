"""The port's speculative programs -- ``spec_generate``, ``spec_tick`` and
``_draft_prefill``, CUDA-graph captures through tputopo_torch._graphs under
the reference's names -- against the reference's jitted programs, on the
reference's tiny f32 config (vocab 64, d_model 32, 4 layers).

On the CPU each program runs its body eagerly, so the CPU tests hold:

- ``spec_generate``'s device-scalar verify step, driven in rounds, against
  the reference's ``spec_generate`` (a ``lax.while_loop``): tokens and
  stats equal on the gamma x depth cases of tests/test_torch_speculative.py,
  and again through a stand-in graph whose replay re-runs the body on the
  static buffers, with one capture per program and exactly one replayed
  step per target step after the prefill (no step runs past the end);
- ``_draft_prefill`` for several slots of a busy draft cache against the
  reference's: every row outside the written window exactly, the window
  within f32 rounding (int8 within one rounding step), and the slot's
  draft length set from the same device scalars;
- the speculative engine whose programs all replay through the stand-in
  against the engine driven eagerly through the same bodies: the same
  tokens, streamed in the same pieces, and the same metrics.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import model as jm
from tputopo.workloads import speculative as js
from tputopo_torch import _graphs
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import serving as tsv
from tputopo_torch import speculative as ts

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=96)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
CFGS = {"bf16": (JCFG, TCFG),
        "int8": (dataclasses.replace(JCFG, kv_dtype="int8"),
                 dataclasses.replace(TCFG, kv_dtype="int8"))}
# The written window's K/V come out of f32 matmuls that XLA and torch sum
# in other orders: a few f32 ulps (as tests/test_torch_compiled.py).
WINDOW_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


# ---- a stand-in graph (the CPU has none) ------------------------------------

class _StandInGraph:
    """Replays by re-running the body on the static input buffers, and
    writes what it returns into the outputs the capture handed out, as a
    CUDA graph rewrites its pool tensors."""

    def __init__(self, body, inputs, outputs):
        self.body, self.inputs, self.outputs = body, inputs, outputs

    def replay(self):
        out = self.body(*self.inputs)
        for dst, src in zip(_graphs.tensors(self.outputs), _graphs.tensors(out)):
            dst.copy_(src)


def _stand_in_capture(self, name, body, device, inputs, mutated, generator, bound_sig):
    """Programs._capture on the CPU: static buffers, the outputs' tensors
    from a run whose mutations are undone (the capture itself computes
    nothing), and a stand-in graph."""
    static_in = tuple(t.clone() for t in inputs)
    saved = [t.clone() for t in _graphs.tensors(mutated)]
    outputs = body(*static_in)
    for t, s in zip(_graphs.tensors(mutated), saved):
        t.copy_(s)
    self.captures[name] += 1
    return _graphs._Entry(bound_sig, _StandInGraph(body, static_in, outputs), static_in,
                          outputs, {}, generator)


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA path of _graphs on CPU tensors, with stand-in graphs."""
    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)


# ---- spec_generate ----------------------------------------------------------

def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"], (1, n))


def _reference(weights, prompt, max_new, **kw):
    jp, _ = weights
    tokens, stats = js.spec_generate(jp, jnp.asarray(prompt), JCFG, max_new=max_new, **kw)
    return np.asarray(tokens), {k: int(v) for k, v in stats.items()}


@pytest.mark.parametrize("draft_layers", [1, 2])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_spec_generate_rounds_match_the_reference(weights, gamma, draft_layers):
    """The device-scalar body, driven in rounds, against the reference's
    while_loop: tokens and stats equal, eagerly (the CPU's path) and as
    its eager twin ``spec_generate_eager``."""
    _, tp = weights
    prompt = _prompt(1, 7)
    want, want_stats = _reference(weights, prompt, 12, draft_layers=draft_layers,
                                  gamma=gamma)
    for fn in (ts.spec_generate, ts.spec_generate_eager):
        got, stats = fn(tp, torch.from_numpy(prompt), TCFG, max_new=12,
                        draft_layers=draft_layers, gamma=gamma)
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats == want_stats


@pytest.mark.parametrize("gamma,max_new", [(1, 12), (3, 12), (5, 2), (4, 9)])
def test_spec_generate_replayed_matches_the_reference(weights, stand_in, gamma, max_new):
    """Through stand-in graphs: the prefill and the verify step captured
    once each, one replayed step per target step after the prefill (the
    rounds never run a step past the end), a second call replaying both
    programs; tokens and stats the reference's."""
    _, tp = weights
    prompt = _prompt(2, 6)
    want, want_stats = _reference(weights, prompt, max_new, draft_layers=2, gamma=gamma)
    progs = _graphs.Programs()
    for call in (1, 2):
        got, stats = ts.spec_generate(tp, torch.from_numpy(prompt), TCFG, max_new=max_new,
                                      draft_layers=2, gamma=gamma, programs=progs)
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats == want_stats
        assert dict(progs.captures) == {"spec_prefill": 1, "spec_step": 1}
        assert progs.replays["spec_prefill"] == call
        assert progs.replays["spec_step"] == call * (stats["target_steps"] - 1)


def test_spec_generate_checks_ids_on_entry(weights, stand_in):
    _, tp = weights
    with pytest.raises(ValueError, match="token ids"):
        ts.spec_generate(tp, torch.tensor([[3, 64]]), TCFG, max_new=4, draft_layers=1,
                         programs=_graphs.Programs())


# ---- _draft_prefill ---------------------------------------------------------

SLOTS, BUF = 3, 24


def _busy_cache(cfg, seed):
    """A draft cache full of random rows, as numpy."""
    rng = np.random.default_rng(seed)
    shape = (2, SLOTS, BUF, BASE["n_kv_heads"], BASE["d_model"] // BASE["n_heads"])
    if cfg.kv_dtype == "int8":
        return ([rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
                + [rng.uniform(0.001, 0.05, shape[:-1] + (1,)).astype(np.float32)
                   for _ in range(2)])
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)] + [None, None]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("replayed", [False, True])
def test_draft_prefill_matches_the_reference(weights, monkeypatch, kv, replayed):
    """Three admissions into a busy draft cache (slots 2, 0, 1; widths 8, 4,
    8) against the reference's ``_draft_prefill``: each slot's window
    within f32 rounding, every other row exactly, and ``dlen[slot]`` the
    prompt's length.  Replayed through stand-in graphs, one capture per
    width serves every slot."""
    if replayed:
        monkeypatch.setattr(_graphs, "graphed", lambda device: True)
        monkeypatch.setattr(_graphs.Programs, "_capture", _stand_in_capture)
    jp, tp = weights
    jcfg, tcfg = CFGS[kv]
    jdraft, jdcfg = js.draft_slice(jp, jcfg, 2)
    tdraft, tdcfg = ts.draft_slice(tp, tcfg, 2)
    arrays = _busy_cache(tcfg, 7)
    jcache = jd.KVCache(*(None if b is None else jnp.asarray(b) for b in arrays))
    tcache = td.KVCache(*(None if b is None else torch.from_numpy(b.copy())
                          for b in arrays))
    dlen = torch.tensor([5, 6, 7])
    progs = _graphs.Programs()
    done = set()
    for i, (slot, width, plen) in enumerate([(2, 8, 6), (0, 4, 4), (1, 8, 3)]):
        prompt = np.zeros(width, np.int64)
        prompt[:plen] = np.random.default_rng(i).integers(0, 64, plen)
        jcache = js._draft_prefill(jdraft, jdcfg, jcache, jnp.int32(slot),
                                   jnp.asarray(prompt, jnp.int32))
        ts._draft_prefill(tdraft, tdcfg, tcache, slot, torch.from_numpy(prompt),
                          dlen=dlen, prompt_len=plen, programs=progs)
        done.add((slot, width))
        for got, ref in zip(tcache, jcache):
            if got is None:
                assert ref is None
                continue
            got, ref = got.numpy(), np.asarray(ref)
            inside = np.zeros(got.shape[:3], bool)
            for s, w in done:
                inside[:, s, :w] = True
            np.testing.assert_array_equal(got[~inside], ref[~inside])
            if got.dtype == np.int8:  # a rounding step may move a value by one
                assert np.abs(got[inside].astype(int) - ref[inside]).max() <= 1
            else:
                np.testing.assert_allclose(got[inside], ref[inside], rtol=WINDOW_TOL,
                                           atol=WINDOW_TOL)
        assert int(dlen[slot]) == plen
    assert dlen.tolist() == [4, 3, 6]
    if replayed:
        assert progs.captures["_draft_prefill"] == 2  # widths 8 and 4
        assert progs.replays["_draft_prefill"] == 3


# ---- the speculative engine -------------------------------------------------

class _EagerSpec(ts.SpecServingEngine):
    """The engine driven eagerly: every program its body run op by op."""

    def _program(self, name, *args, **kw):
        return (ts.EAGER_PROGRAMS.get(name) or getattr(tsv, name))(*args, **kw)


def _serve(cls, tp, cfg, eos_id):
    streamed = []
    eng = cls(tp, cfg, slots=2, max_len=28, prompt_pad=(4, 8), draft_layers=2, gamma=3,
              eos_id=eos_id, on_tokens=lambda rid, toks: streamed.append((rid, toks)))
    rng = np.random.default_rng(11)
    ids = [eng.submit(rng.integers(0, 64, n).tolist(), max_new=m)
           for n, m in ((3, 9), (8, 5), (5, 12), (2, 7), (7, 4))]
    res = eng.run()
    return [res[i] for i in ids], streamed, dict(eng.metrics), eng


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("eos_id", [-1, 17])
def test_replayed_spec_engine_equals_the_eager_engine(weights, stand_in, kv, eos_id):
    """Every program of the speculative engine replayed from its static
    buffers (the admissions, the draft prefill and the tick) gives the
    eager engine's tokens, streamed in the same pieces, and its metrics,
    with one capture per program and width."""
    _, tp = weights
    cfg = CFGS[kv][1]
    want = _serve(_EagerSpec, tp, cfg, eos_id)
    got = _serve(ts.SpecServingEngine, tp, cfg, eos_id)
    assert got[:3] == want[:3]
    progs = got[3].programs
    assert dict(progs.captures) == {"admit": 2, "_draft_prefill": 2, "spec_tick": 1}
    assert progs.replays["spec_tick"] == got[2]["decode_steps"]
    assert progs.replays["_draft_prefill"] == progs.replays["admit"] == 5
    assert not want[3].programs.captures
