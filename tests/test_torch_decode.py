"""The port's KV-cache decode (tputopo_torch.decode) against the JAX
package's ``generate``: greedy token for token at f32.  Sampling draws
from a torch.Generator, whose stream JAX's PRNG cannot reproduce, so only
its contract is checked."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import decode as jd
from tputopo.workloads import model as jm
from tputopo_torch import decode as td
from tputopo_torch import model as tm

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=64)
JCFG = jm.ModelConfig(**BASE, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(**BASE, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jm.init_params(JCFG, jax.random.key(0))
    return jp, to_torch(jp)


@pytest.mark.parametrize("seed,batch,prompt_len,max_new", [
    (0, 2, 5, 6), (1, 3, 1, 4), (2, 1, 12, 1)])
def test_greedy_generate_matches_jax(params, seed, batch, prompt_len, max_new):
    jp, tp = params
    prompt = np.random.default_rng(seed).integers(0, 64, (batch, prompt_len))
    ref = np.asarray(jd.generate(jp, jnp.asarray(prompt), JCFG, max_new=max_new))
    out = td.generate(tp, torch.from_numpy(prompt), TCFG, max_new=max_new)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_greedy_generate_matches_full_forward(params):
    """The cached path reproduces re-running the port's whole forward."""
    _, tp = params
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (2, 5)))
    out = td.generate(tp, toks, TCFG, max_new=5)
    for _ in range(5):
        nxt = tm.forward(tp, toks, TCFG)[:, -1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert torch.equal(out, toks)


def test_sampling_modes(params):
    _, tp = params
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 4)))

    def sample(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return td.generate(tp, prompt, TCFG, max_new=6, generator=gen, **kw)

    greedy = td.generate(tp, prompt, TCFG, max_new=6)
    # top_k=1 sampling is greedy whatever the temperature
    assert torch.equal(sample(7, temperature=1.0, top_k=1), greedy)
    a, b, c = (sample(s, temperature=5.0) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    for out in (a, sample(3, temperature=1.0, top_k=5)):
        assert out.shape == (2, 10) and torch.equal(out[:, :4], prompt)
        assert int(out.min()) >= 0 and int(out.max()) < 64
    with pytest.raises(ValueError, match="torch.Generator"):
        td.generate(tp, prompt, TCFG, max_new=2, temperature=1.0)


def test_top_k_restricts_the_draw():
    logits = torch.tensor([[0.0, 3.0, 2.0, -1.0, 2.5]]).repeat(64, 1)
    gen = torch.Generator().manual_seed(0)
    picks = td._select(logits, 10.0, 2, gen)
    assert set(picks.tolist()) <= {1, 4}


def test_cache_shapes_and_validation(params):
    _, tp = params
    cache = td.KVCache.create(TCFG, 3, 16, device="cpu")
    assert cache.k.shape == cache.v.shape == (2, 3, 16, 2, 8)
    assert cache.k.dtype == torch.float32
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="max_len"):
        td.generate(tp, prompt, TCFG, max_new=8, max_len=6)
    with pytest.raises(ValueError, match="max_new"):
        td.generate(tp, prompt, TCFG, max_new=0)
    assert cache.k_scale is None and cache.v_scale is None
    int8 = tm.ModelConfig(**BASE, compute_dtype=torch.float32, kv_dtype="int8")
    c8 = td.KVCache.create(int8, 3, 16, device="cpu")
    assert c8.k.dtype == c8.v.dtype == torch.int8
    assert c8.k_scale.dtype == torch.float32
    assert c8.k_scale.shape == c8.v_scale.shape == (2, 3, 16, 2, 1)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        td.KVCache.create(tm.ModelConfig(**BASE, kv_dtype="fp8"), 1, 8, device="cpu")
