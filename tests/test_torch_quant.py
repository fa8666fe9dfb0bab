"""The port's quantization (tputopo_torch.quant) against the JAX package's
``tputopo.workloads.quant``: quantized values and scales bit-exact, every
``qdot`` arm at f32, ``streamed_bytes`` equal, and the quantized forward
and int8-KV decode against JAX's.  The int4 leaves compare through
:func:`tputopo_torch.convert.params_from_numpy`, which packs JAX's int4
arrays two per byte as the port stores them."""

import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import model as jm
from tputopo.workloads import quant as jq
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import quant as tq

torch.set_num_threads(1)

BASE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)
# (bits, group_size): int8; int4 with four groups of 16 over d_model; int4
# whose group walks down to the whole input dim (64 < 128, 128 = d_ff).
SCHEMES = [(8, 128), (4, 16), (4, 128)]
# The reference's model-level f32 tolerance (tests/test_attention.py).
FWD_TOL = 2e-4


@pytest.fixture(scope="module")
def params():
    """The JAX tree with a zero output channel in a layer weight and a
    zero row in the embedding (scale 1/127, values exactly 0), and its
    torch twin."""
    jp = jm.init_params(JCFG, jax.random.key(0))
    jp["layers"]["wq"] = jp["layers"]["wq"].at[1, :, 3].set(0.0)
    jp["embed"] = jp["embed"].at[5].set(0.0)
    return jp, to_torch(jp)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    assert torch.equal(a, b), path


@pytest.mark.parametrize("bits,group", SCHEMES)
def test_quantized_tree_is_bit_exact(params, bits, group):
    jp, tp = params
    ref = jq.quantize_params(jp, bits=bits, group_size=group)
    out = tq.quantize_params(tp, bits=bits, group_size=group)
    _assert_trees_equal(to_torch(ref), out)
    zero = out["layers"]["wq"]
    key = "int8" if bits == 8 else "int4"
    assert not bool(tq.deq(zero, torch.float32)[1, :, 3].any())
    assert torch.equal(out["embed"]["scale"][5], torch.tensor([1 / 127]))
    assert out["layers"]["attn_norm"].dtype == torch.float32
    assert zero[key].dtype == (torch.int8 if bits == 8 else torch.uint8)
    # the input tree is left as it is
    assert torch.equal(tp["layers"]["wq"], to_torch(jp)["layers"]["wq"])


def test_degraded_int4_group_warns_and_matches():
    """13 is prime: group 4 walks down to 1, and both sides warn."""
    w = np.random.default_rng(1).normal(size=(13, 8)).astype(np.float32)
    tree = {"embed": w, "lm_head": w, "final_norm": w[0], "layers": {"wq": w[None]}}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ref = jq.quantize_params(jax.tree.map(jnp.asarray, tree), bits=4, group_size=4)
        out = tq.quantize_params(jax.tree.map(torch.from_numpy, tree), bits=4,
                                 group_size=4)
    msgs = [str(r.message) for r in rec if "group size degraded" in str(r.message)]
    assert len(msgs) == 4 and msgs[0] == msgs[2]  # lm_head + wq, each side
    _assert_trees_equal(to_torch(ref), out)
    assert out["layers"]["wq"]["int4"].shape == (1, 13, 1, 4)  # [L, G, g, out/2]


def test_int4_packing_order_and_roundtrip():
    q = torch.arange(-8, 8, dtype=torch.int8).reshape(2, 8)
    p = tq.pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (2, 4)
    assert torch.equal(tq.unpack_int4(p), q)
    # column 2j in the low nibble, 2j + 1 in the high one, two's complement
    assert tq.pack_int4(torch.tensor([1, -1], dtype=torch.int8)).item() == 0xF1
    with pytest.raises(ValueError, match="even last axis"):
        tq.pack_int4(torch.zeros(3, dtype=torch.int8))


def _leaf(scheme):
    """One weight [64, 32] quantized by ``scheme`` (None = raw), sliced to a
    layer as the model's loop does, on both sides."""
    w = np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)
    tree = {"embed": w, "lm_head": w, "final_norm": w[0], "layers": {"wq": w[None]}}
    if scheme is None:
        return jnp.asarray(w), torch.from_numpy(w)
    bits, group = scheme
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, tree), bits=bits,
                               group_size=group)
    jl = jax.tree.map(lambda a: a[0], jtree["layers"]["wq"])
    return jl, tm._layer(to_torch(jtree)["layers"], 0)["wq"]


@pytest.mark.parametrize("scheme", [None, (8, 128), (4, 16), (4, 64)])
def test_qdot_matches_jax(scheme):
    jl, tl = _leaf(scheme)
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    ref = np.asarray(jq.qdot(jnp.asarray(x), jl))
    out = tq.qdot(torch.from_numpy(x), tl)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_qdot_rejects_stacked_int4_and_lora():
    _, tl = _leaf((4, 16))
    stacked = {k: a[None] for k, a in tl.items()}  # [1, G, g, out/2]
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="scan-slice"):
        tq.qdot(x, stacked)
    # a LoRA leaf takes the same rule for its base (its arm is held
    # against the reference in test_torch_lora.py)
    lora = {"lora_base": stacked, "lora_a": torch.zeros(64, 2),
            "lora_b": torch.zeros(2, 32), "lora_scale": torch.ones(())}
    with pytest.raises(ValueError, match="scan-slice"):
        tq.qdot(x, lora)


@pytest.mark.parametrize("scheme", [None, (8, 128), (4, 16)])
def test_deq_matches_jax_exactly(scheme):
    jl, tl = _leaf(scheme)
    np.testing.assert_array_equal(tq.deq(tl, torch.float32).numpy(),
                                  np.asarray(jq.deq(jl, jnp.float32)))


@pytest.mark.parametrize("bits", [None, 8])
def test_deq_rows_matches_jax_exactly(params, bits):
    jp, tp = params
    if bits:
        jp, tp = jq.quantize_params(jp, bits=bits), tq.quantize_params(tp, bits=bits)
    idx = np.array([[0, 5, 7], [127, 5, 1]])
    ref = np.asarray(jq.deq_rows(jp["embed"], jnp.asarray(idx), jnp.float32))
    out = tq.deq_rows(tp["embed"], torch.from_numpy(idx), torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_quantize_kv_and_fold_match_jax_exactly():
    x = np.random.default_rng(4).normal(size=(2, 6, 3, 8)).astype(np.float32)
    x[1, 2, 0] = 0.0  # a zero row: scale 1/127, values 0
    jqv, js = jq.quantize_kv(jnp.asarray(x))
    tqv, ts = tq.quantize_kv(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and ts.shape == (2, 6, 3, 1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    folded = tq.fold_kv_scale(ts)
    assert folded.shape == (2, 3, 1, 1, 6)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(jq.fold_kv_scale(js)))


@pytest.mark.parametrize("scheme,itemsize", [
    (None, 2), (None, 4), ((8, 128), 2), ((4, 16), 2), ((4, 128), 2)])
def test_streamed_bytes_equal(params, scheme, itemsize):
    jp, tp = params
    if scheme:
        bits, group = scheme
        jp = jq.quantize_params(jp, bits=bits, group_size=group)
        tp = tq.quantize_params(tp, bits=bits, group_size=group)
    assert tq.streamed_bytes(tp, itemsize) == jq.streamed_bytes(jp, itemsize)


def test_streamed_bytes_ratios():
    """The reference's byte budget: int8 under 55% of raw, int4 under 75%
    of int8 (tests/test_quant.py), on the port's stored bytes."""
    cfg = tm.ModelConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=8,
                         n_kv_heads=4, d_ff=512, max_seq=64)
    raw = tm.init_params(cfg, 0, device="cpu")
    i8 = tq.streamed_bytes(tq.quantize_params(raw))
    i4 = tq.streamed_bytes(tq.quantize_params(raw, bits=4))
    assert i8 / tq.streamed_bytes(raw) < 0.55 and i4 / i8 < 0.75


def test_params_from_numpy_takes_a_jax_int4_tree(params):
    jp, tp = params
    jtree = jq.quantize_params(jp, bits=4, group_size=16)
    assert jtree["lm_head"]["int4"].dtype == jnp.int4
    got = to_torch(jtree, dtype=torch.bfloat16)  # scales stay f32
    leaf = got["layers"]["w_down"]  # [L, in 128, out 64] -> G 8, g 16
    assert leaf["int4"].dtype == torch.uint8 and leaf["int4"].shape == (2, 8, 16, 32)
    assert leaf["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        tq.unpack_int4(leaf["int4"]).numpy(),
        np.asarray(jtree["layers"]["w_down"]["int4"]).astype(np.int8))
    assert got["embed"]["int8"].dtype == torch.int8


@pytest.mark.parametrize("scheme", [(8, 128), (4, 16)])
def test_quantized_forward_matches_jax(params, scheme):
    jp, tp = params
    bits, group = scheme
    jqp = jq.quantize_params(jp, bits=bits, group_size=group)
    tqp = tq.quantize_params(tp, bits=bits, group_size=group)
    toks = np.random.default_rng(5).integers(0, 128, (2, 16))
    ref = np.asarray(jm.forward(jqp, jnp.asarray(toks), JCFG))
    out = tm.forward(tqp, torch.from_numpy(toks), TCFG)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_TOL, rtol=FWD_TOL)


def test_int4_bf16_forward_matches_jax(params):
    """bf16 compute over int4 weights; the int4 matmul itself is f32 on
    both sides.  Bound as tests/test_torch_model.py's bf16 forward (8 bf16
    ulps at |logit| ~ 4)."""
    jp, tp = params
    jcfg = dataclasses.replace(JCFG, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)
    jqp = jq.quantize_params(jp, bits=4, group_size=16)
    toks = np.random.default_rng(6).integers(0, 128, (2, 16))
    ref = np.asarray(jm.forward(jqp, jnp.asarray(toks), jcfg))
    out = tm.forward(tq.quantize_params(tp, bits=4, group_size=16),
                     torch.from_numpy(toks), tcfg)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, atol=0.125, rtol=0.125)


@pytest.mark.parametrize("weights,seed,batch,prompt_len,max_new", [
    (None, 0, 2, 8, 8), (None, 1, 3, 1, 5), (8, 2, 2, 5, 6)])
def test_int8_kv_generate_matches_jax(params, weights, seed, batch, prompt_len,
                                      max_new):
    jp, tp = params
    if weights:
        jp, tp = jq.quantize_params(jp, bits=weights), tq.quantize_params(tp, bits=weights)
    jcfg = dataclasses.replace(JCFG, kv_dtype="int8")
    tcfg = dataclasses.replace(TCFG, kv_dtype="int8")
    prompt = np.random.default_rng(seed).integers(0, 128, (batch, prompt_len))
    ref = np.asarray(jd.generate(jp, jnp.asarray(prompt), jcfg, max_new=max_new))
    out = td.generate(tp, torch.from_numpy(prompt), tcfg, max_new=max_new)
    np.testing.assert_array_equal(out.numpy(), ref)
