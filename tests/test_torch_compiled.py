"""The port's compiled programs (the ``*_jit`` functions of
tputopo_torch.serving, .decode and .model, CUDA-graph captures through
tputopo_torch._graphs) against the reference's ``jax.jit`` programs.

On the CPU every program runs its body eagerly, so the CPU tests hold:

- the device-scalar admission bodies against the reference's
  ``admit_jit``, ``prefill_chunk_jit``, ``admit_final_chunk_jit``,
  ``copy_prefix_jit`` and ``build_prefix_cache_jit`` on the same
  numpy-seeded state, at f32, over several slots and starts (a negative
  start, a window at the buffer's end, a start past it): the token rows,
  ``length``, ``prompt_len``, ``budget``, ``seq_id``, ``done`` and every
  cache row outside the written window exactly; the written window within
  f32 rounding (the two frameworks' matmuls sum in other orders);
- each ``*_jit`` against its eager function, ``generate_jit`` against
  ``generate``, ``forward_jit`` against the reference's ``forward_jit``;
- the capture logic itself, through a stand-in graph whose replay re-runs
  the body on the static buffers: an engine whose programs all replay so
  gives the eager engine's tokens, with one capture per (program, width),
  and a capture error raises with nothing run eagerly in its place; the
  process-wide default keeps one graph per shape, a new params tree
  replacing it.

The ``cuda``-marked test holds a real replay against the eager run bit for
bit on the card, one capture per key, and a recapture when the params'
storage changes; it skips where there is no GPU.
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
from tputopo.workloads import serving as js
from tputopo_torch import _graphs, _kernels
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import serving as ts

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
CFGS = {"bf16": (JCFG, TCFG),
        "int8": (dataclasses.replace(JCFG, kv_dtype="int8"),
                 dataclasses.replace(TCFG, kv_dtype="int8"))}
SLOTS, MAX_LEN = 3, 16
# The written window's K/V (and int8 scales) come out of f32 matmuls that
# XLA and torch sum in other orders: a few f32 ulps of values of |x| ~ 4.
WINDOW_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


def _state_arrays(seed: int, kv: str) -> dict:
    """A busy decode state as numpy: random cache contents, token rows and
    per-slot vectors."""
    rng = np.random.default_rng(seed)
    L, KV, H = BASE["n_layers"], BASE["n_kv_heads"], BASE["d_model"] // BASE["n_heads"]
    shape = (L, SLOTS, MAX_LEN, KV, H)
    if kv == "int8":
        cache = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        cache += [rng.uniform(0.001, 0.05, shape[:-1] + (1,)).astype(np.float32)
                  for _ in range(2)]
    else:
        cache = [rng.normal(size=shape).astype(np.float32) for _ in range(2)] + [None, None]
    return dict(cache=cache, tokens=rng.integers(0, 64, (SLOTS, MAX_LEN)),
                length=rng.integers(1, MAX_LEN, SLOTS),
                prompt_len=rng.integers(1, 8, SLOTS), budget=rng.integers(1, 8, SLOTS),
                seq_id=np.array([4, -1, 7]), done=np.array([False, True, False]))


def _jax_state(a: dict) -> js.DecodeState:
    def i32(x):
        return jnp.asarray(x, jnp.int32)

    return js.DecodeState(
        cache=jd.KVCache(*(None if b is None else jnp.asarray(b) for b in a["cache"])),
        tokens=i32(a["tokens"]), length=i32(a["length"]),
        prompt_len=i32(a["prompt_len"]), budget=i32(a["budget"]),
        seq_id=i32(a["seq_id"]), done=jnp.asarray(a["done"]), step=jnp.int32(0))


def _torch_state(a: dict) -> ts.DecodeState:
    def i64(x):  # a copy: the port's programs write the state in place
        return torch.from_numpy(np.array(x, np.int64))

    return ts.DecodeState(
        cache=td.KVCache(*(None if b is None else torch.from_numpy(b.copy())
                           for b in a["cache"])),
        tokens=i64(a["tokens"]), length=i64(a["length"]),
        prompt_len=i64(a["prompt_len"]), budget=i64(a["budget"]),
        seq_id=i64(a["seq_id"]), done=torch.from_numpy(a["done"].copy()))


def _assert_state_equal(tstate, jstate, window=None):
    """Every per-slot vector and token row exactly; the cache exactly
    outside ``window`` = (slot, first row, width) and within WINDOW_TOL
    inside it."""
    for name in ("tokens", "length", "prompt_len", "budget", "seq_id", "done"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    for got, ref in zip(tstate.cache, jstate.cache):
        if got is None:
            assert ref is None
            continue
        got, ref = got.numpy(), np.asarray(ref)
        if window is None:
            np.testing.assert_array_equal(got, ref)
            continue
        slot, lo, width = window
        inside = np.zeros(got.shape[:3], bool)
        inside[:, slot, lo:lo + width] = True
        np.testing.assert_array_equal(got[~inside], ref[~inside])
        if got.dtype == np.int8:  # a rounding step may move a value by one
            assert np.abs(got[inside].astype(int) - ref[inside]).max() <= 1
        else:
            np.testing.assert_allclose(got[inside], ref[inside], rtol=WINDOW_TOL,
                                       atol=WINDOW_TOL)


def _window(start: int, width: int) -> int:
    """Where dynamic_update_slice writes a ``width`` window at ``start``."""
    start = start + MAX_LEN if start < 0 else start
    return min(max(start, 0), MAX_LEN - width)


# (slot, width, start, prompt_len): admit takes start 0; the chunks take a
# start inside the buffer, a window ending at its end, a start past its end
# (clamped back), and a negative start (counted once from the end).
CHUNK_CASES = [(0, 4, 0, 3), (1, 4, 5, 8), (2, 4, MAX_LEN - 4, MAX_LEN - 2),
               (1, 2, MAX_LEN, MAX_LEN - 1), (2, 4, -3, 2), (0, 8, -9, 12)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("slot,width,plen", [(0, 4, 3), (2, 8, 8), (1, 8, 1)])
def test_admit_matches_reference_admit_jit(weights, kv, slot, width, plen):
    jp, tp = weights
    jcfg, tcfg = CFGS[kv]
    a = _state_arrays(10 + slot, kv)
    prompt = np.zeros(width, np.int64)
    prompt[:plen] = np.random.default_rng(slot).integers(0, 64, plen)
    ref = js.admit_jit(jp, _jax_state(a), jcfg, jnp.int32(slot), jnp.asarray(prompt, jnp.int32),
                       jnp.int32(plen), jnp.int32(30 + slot), jnp.int32(5), jnp.int32(-1))
    for fn in (ts.admit, ts.admit_jit):
        st = _torch_state(a)
        fn(tp, st, tcfg, slot, torch.from_numpy(prompt), plen, 30 + slot, 5, -1)
        _assert_state_equal(st, ref, (slot, 0, width))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("slot,width,start,plen", CHUNK_CASES)
def test_prefill_chunk_matches_reference(weights, kv, slot, width, start, plen):
    jp, tp = weights
    jcfg, tcfg = CFGS[kv]
    a = _state_arrays(20 + slot, kv)
    chunk = np.random.default_rng(start + 50).integers(0, 64, width)
    ref = js.prefill_chunk_jit(jp, _jax_state(a), jcfg, jnp.int32(slot),
                               jnp.asarray(chunk, jnp.int32), jnp.int32(start))
    for fn in (ts.prefill_chunk, ts.prefill_chunk_jit):
        st = _torch_state(a)
        fn(tp, st, tcfg, slot, torch.from_numpy(chunk), start)
        _assert_state_equal(st, ref, (slot, _window(start, width), width))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("slot,width,start,plen", CHUNK_CASES)
def test_admit_final_chunk_matches_reference(weights, kv, slot, width, start, plen):
    """The first token is picked at the clamped index prompt_len - 1 -
    start of the chunk, and the slot activates with a max_len row."""
    jp, tp = weights
    jcfg, tcfg = CFGS[kv]
    a = _state_arrays(30 + slot, kv)
    rng = np.random.default_rng(start + 70)
    row = np.zeros(MAX_LEN, np.int64)
    row[:plen] = rng.integers(0, 64, plen)
    chunk = rng.integers(0, 64, width)
    eos = int(a["tokens"][0, 0])
    ref = js.admit_final_chunk_jit(
        jp, _jax_state(a), jcfg, jnp.int32(slot), jnp.asarray(row, jnp.int32),
        jnp.asarray(chunk, jnp.int32), jnp.int32(start), jnp.int32(plen),
        jnp.int32(9), jnp.int32(3), jnp.int32(eos))
    for fn in (ts.admit_final_chunk, ts.admit_final_chunk_jit):
        st = _torch_state(a)
        fn(tp, st, tcfg, slot, torch.from_numpy(row), torch.from_numpy(chunk), start,
           plen, 9, 3, eos)
        _assert_state_equal(st, ref, (slot, _window(start, width), width))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("P", [1, 5])
def test_build_and_copy_prefix_match_reference(weights, kv, P):
    jp, tp = weights
    jcfg, tcfg = CFGS[kv]
    toks = np.random.default_rng(P).integers(0, 64, P)
    jpre = js.build_prefix_cache_jit(jp, jcfg, jnp.asarray(toks, jnp.int32))
    pres = [fn(tp, tcfg, torch.from_numpy(toks))
            for fn in (ts.build_prefix_cache, ts.build_prefix_cache_jit)]
    for pre in pres:
        for got, ref in zip(pre, jpre):
            if got is None:
                continue
            if got.dtype == torch.int8:
                assert np.abs(got.numpy().astype(int) - np.asarray(ref)).max() <= 1
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=WINDOW_TOL, atol=WINDOW_TOL)
    # The copy, from the same prefix rows on both sides: exact.
    a = _state_arrays(40 + P, kv)
    # the reference's cache fields (the port's adds ``routes``, None here)
    pre_np = [None if b is None else b.numpy() for b in pres[0]][:len(jd.KVCache._fields)]
    assert pres[0].routes is None
    for slot in (0, 2):
        ref = js.copy_prefix_jit(_jax_state(a), jd.KVCache(
            *(None if b is None else jnp.asarray(b) for b in pre_np)), jnp.int32(slot))
        for fn in (ts.copy_prefix, ts.copy_prefix_jit):
            st = _torch_state(a)
            fn(st, td.KVCache(*(None if b is None else torch.from_numpy(b.copy())
                                for b in pre_np)), slot)
            _assert_state_equal(st, ref)


def test_admission_rejects_a_slot_out_of_range(weights):
    """The reference clamps a slot index; a device gather would fault, so
    the port refuses it before any device work."""
    _, tp = weights
    st = _torch_state(_state_arrays(1, "bf16"))
    for slot in (-1, SLOTS):
        with pytest.raises(ValueError, match="slot"):
            ts.prefill_chunk_jit(tp, st, TCFG, slot, torch.tensor([1, 2]), 0)
        with pytest.raises(ValueError, match="slot"):
            ts.copy_prefix(st, td.KVCache(st.cache.k[:, :1, :2], st.cache.v[:, :1, :2]),
                           slot)


@pytest.mark.parametrize("steps", [1, 3])
def test_decode_programs_match_eager_and_reference(weights, steps):
    """decode_step(s)_jit on the CPU equal the eager steps, and both equal
    the reference's decode_steps_jit on the same busy state (greedy)."""
    jp, tp = weights
    a = _state_arrays(50 + steps, "bf16")
    ref = js.decode_steps_jit(jp, _jax_state(a), JCFG, jnp.int32(-1), n=steps)
    eager = _torch_state(a)
    ts.decode_steps(tp, eager, TCFG, -1, steps)
    st = _torch_state(a)
    if steps == 1:
        ts.decode_step_jit(tp, st, TCFG, -1)
    else:
        ts.decode_steps_jit(tp, st, TCFG, -1, steps)
    for name in ("tokens", "length", "done"):
        assert torch.equal(getattr(st, name), getattr(eager, name)), name
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for got, want in zip(st.cache, eager.cache):
        if got is not None:
            assert torch.equal(got, want)


@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.9, 4)])
def test_generate_jit_equals_generate(weights, temperature, top_k):
    _, tp = weights
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 5)))

    def gen(fn):
        g = torch.Generator().manual_seed(11) if temperature else None
        return fn(tp, prompt, TCFG, max_new=6, max_len=12, temperature=temperature,
                  top_k=top_k, generator=g)

    out = gen(td.generate_jit)
    assert torch.equal(out, gen(td.generate))
    if not temperature:
        # The reference's compile cache is the process's: empty it again, so
        # a later test that counts its entries is not handed these shapes.
        try:
            ref = jd.generate_jit(weights[0], jnp.asarray(prompt.numpy(), jnp.int32),
                                  JCFG, max_new=6, max_len=12)
        finally:
            jd.generate_jit.clear_cache()
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_forward_jit_matches_reference_forward_jit(weights):
    jp, tp = weights
    tokens = np.random.default_rng(4).integers(0, 64, (2, 16))
    ref = np.asarray(jm.forward_jit(jp, jnp.asarray(tokens), JCFG))
    out = tm.forward_jit(tp, torch.from_numpy(tokens), TCFG)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 16, 64)
    assert torch.equal(out, tm.forward(tp, torch.from_numpy(tokens), TCFG))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_jit_programs_check_host_ids(weights):
    """Ids are checked where host input enters a program (a CUDA graph
    cannot read them back inside)."""
    _, tp = weights
    st = _torch_state(_state_arrays(2, "bf16"))
    with pytest.raises(ValueError, match="token ids"):
        ts.admit_jit(tp, st, TCFG, 0, torch.tensor([1, 64]), 2, 1, 2, -1)
    with pytest.raises(ValueError, match="token ids"):
        td.generate_jit(tp, torch.tensor([[-1, 2]]), TCFG, max_new=1)
    with pytest.raises(ValueError, match="token ids"):
        tm.forward_jit(tp, torch.tensor([[3, 99]]), TCFG)


# ---- the capture logic, through a stand-in graph ---------------------------

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


def _stream(eng, prompts, news, prefix=None):
    pid = eng.register_prefix(prefix) if prefix else None
    ids = [eng.submit(p, max_new=m, prefix=pid if i % 2 == 0 else None)
           for i, (p, m) in enumerate(zip(prompts, news))]
    res = eng.run()
    return [res[i] for i in ids]


# (engine settings, the captures the stream below must make: one per
# program and width)
ENGINES = {
    "buckets": (dict(slots=2, max_len=24, prompt_pad=(4, 8)),
                {"admit": 2, "decode_step": 1}),
    "chunked_prefix": (dict(slots=3, max_len=32, prompt_pad=(4, 8), prefill_chunk=4),
                       {"admit": 1, "prefill_chunk": 1, "admit_final_chunk": 1,
                        "build_prefix_cache": 1, "copy_prefix": 1, "decode_step": 1}),
    "steps_per_tick": (dict(slots=2, max_len=24, prompt_pad=8, steps_per_tick=3),
                       {"admit": 1, "decode_steps": 1}),
}


@pytest.mark.parametrize("name", list(ENGINES))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_replays_equal_the_eager_engine(weights, stand_in, name, kv):
    """Every program of the engine replayed from its static buffers gives
    the tokens of an engine driven eagerly, with one capture per program
    and width: a value that reached a body other than through its inputs
    would be stale on the next replay."""
    _, tp = weights
    cfg = CFGS[kv][1]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, n).tolist() for n in (3, 8, 5, 2, 7, 4)]
    news = [5, 3, 6, 4, 2, 5]
    prefix = rng.integers(0, 64, 6).tolist() if name == "chunked_prefix" else None

    class Eager(ts.ServingEngine):
        def _program(self, program, *args, **kw):
            return getattr(ts, program)(*args, **kw)

    kw, captures = ENGINES[name]
    want = _stream(Eager(tp, cfg, **kw), prompts, news, prefix)
    eng = ts.ServingEngine(tp, cfg, **kw)
    assert _stream(eng, prompts, news, prefix) == want
    assert dict(eng.programs.captures) == captures
    per_tick = kw.get("steps_per_tick", 1)
    decode = "decode_step" if per_tick == 1 else "decode_steps"
    assert eng.programs.replays[decode] * per_tick == eng.metrics["decode_steps"]
    if prefix:
        assert eng.programs.replays["copy_prefix"] == 3


def test_keys_follow_shapes_statics_and_storage(weights, stand_in):
    """A new width or static argument captures anew; the same call
    replays; a params tree at other storage recaptures."""
    _, tp = weights
    progs = _graphs.Programs()
    prompt = torch.tensor([[1, 2, 3]])
    outs = [td.generate_jit(tp, prompt, TCFG, max_new=n, programs=progs) for n in (2, 2, 3)]
    assert progs.captures["generate"] == 2 and progs.replays["generate"] == 3
    assert torch.equal(outs[0], outs[1])
    moved = {k: (v.clone() if torch.is_tensor(v) else {n: w.clone() for n, w in v.items()})
             for k, v in tp.items()}
    td.generate_jit(moved, prompt, TCFG, max_new=2, programs=progs)
    assert progs.captures["generate"] == 3
    assert _graphs.signature(moved) != _graphs.signature(tp)
    progs.release()
    assert not progs._graphs and progs.pool is None


def test_capture_error_raises_and_runs_nothing_eagerly(weights, monkeypatch):
    """On the CUDA path a failed capture raises; no eager step runs in its
    place (the decode state is untouched)."""
    _, tp = weights

    def failing_capture(self, *a, **k):
        raise RuntimeError("capture failed (stub)")

    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", failing_capture)
    st = _torch_state(_state_arrays(3, "bf16"))
    before = [t.clone() for t in _graphs.tensors(st)]
    with pytest.raises(RuntimeError, match="capture failed"):
        ts.decode_steps_jit(tp, st, TCFG, -1, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, _graphs.tensors(st)))
    eng = ts.ServingEngine(tp, TCFG, slots=1, max_len=16, prompt_pad=4)
    eng.submit([1, 2], max_new=3)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.step()


def test_default_programs_keep_one_graph_per_shape(weights, stand_in, monkeypatch):
    """The process-wide programs of the ``*_jit`` calls that name no owner
    hold one graph per shape: a params tree at other storage replaces the
    graph (and frees its outputs) instead of adding one; another shape
    adds one.  Each replay still gives its own tree's logits."""
    _, tp = weights
    monkeypatch.setattr(_graphs, "_DEFAULT", _graphs.Programs(latest_only=True))
    progs = _graphs._DEFAULT
    moved = {k: (v.clone() if torch.is_tensor(v) else {n: w.clone() for n, w in v.items()})
             for k, v in tp.items()}
    moved["final_norm"] = moved["final_norm"] * 0.5
    tokens = torch.tensor([[1, 2, 3, 4]])
    for tree in (tp, moved, tp):
        got = tm.forward_jit(tree, tokens, TCFG)
        assert torch.equal(got, tm.forward(tree, tokens, TCFG))
        assert len(progs._graphs) == 1
    assert progs.captures["forward"] == 3
    tm.forward_jit(tp, tokens[:, :3], TCFG)
    tm.forward_jit(tp, tokens, TCFG)
    assert len(progs._graphs) == 2 and progs.captures["forward"] == 4


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_tables_match_the_reference(theta):
    """The tables, built with theta as a CPU scalar (a capture records
    them with the body), equal the reference's within one f32 ulp at
    |x| <= 1: the two frameworks' cos and sin round differently."""
    cfg = dataclasses.replace(TCFG, rope_theta=theta)
    jcfg = dataclasses.replace(JCFG, rope_theta=theta)
    for got, ref in zip(tm._rope_tables(cfg, 40, "cpu"), jm._rope_tables(jcfg, 40)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (40, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=6e-8)


def test_a_capture_counts_launches_at_replay(monkeypatch):
    """A kernel launch recorded by a capture counts once per replay."""
    progs = _graphs.Programs()
    kern = _kernels.FLASH_FWD

    def capture(self, name, body, device, inputs, mutated, generator, bound_sig):
        return _graphs._Entry(bound_sig, _StandInGraph(lambda: None, (), None), (), None,
                              {kern: 32}, None)

    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs.Programs, "_capture", capture)
    before = kern.launches
    for _ in range(3):
        progs.run("forward", lambda: None, device="cpu", static=())
    assert kern.launches == before + 96


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replays_on_the_card_equal_the_eager_run(cuda):
    """generate_jit and an engine's programs, replayed, give the eager
    runs' tokens bit for bit; one capture per key; new params storage
    recaptures."""
    cfg = dataclasses.replace(TCFG, n_layers=2)
    params = tm.init_params(cfg, 0, device=cuda)
    prompt = torch.randint(0, 64, (2, 5), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    progs = _graphs.Programs()
    outs = [td.generate_jit(params, prompt, cfg, max_new=6, programs=progs)
            for _ in range(2)]
    assert torch.equal(outs[0], td.generate(params, prompt, cfg, max_new=6))
    assert torch.equal(outs[0], outs[1])
    assert progs.captures["generate"] == 1 and progs.replays["generate"] == 2
    moved = tm.init_params(cfg, 0, device=cuda)
    assert torch.equal(td.generate_jit(moved, prompt, cfg, max_new=6, programs=progs),
                       outs[0])
    assert progs.captures["generate"] == 2

    # A replay after forwards at many other lengths (whose temporaries
    # reuse freed memory) still reads only what its graph holds.
    tokens = prompt.repeat(1, 4)
    want = tm.forward(params, tokens, cfg)
    assert torch.equal(tm.forward_jit(params, tokens, cfg, programs=progs), want)
    for n in range(1, 41):
        tm.forward(params, prompt[:, : 1 + n % 5].repeat(1, 1 + n // 5), cfg)
    assert torch.equal(tm.forward_jit(params, tokens, cfg, programs=progs), want)
    assert progs.captures["forward"] == 1

    class Eager(ts.ServingEngine):
        def _program(self, program, *args, **kw):
            return getattr(ts, program)(*args, **kw)

    rows = []
    for cls in (Eager, ts.ServingEngine):
        eng = cls(params, cfg, slots=2, max_len=24, prompt_pad=(4, 8), prefill_chunk=4)
        rows.append(_stream(eng, [[1, 2, 3], [4] * 8, [5, 6]], [4, 3, 5], [7, 8, 9]))
    assert rows[0] == rows[1]
    assert set(eng.programs.captures.values()) == {1}
