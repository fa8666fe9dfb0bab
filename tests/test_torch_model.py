"""The port's LM forward (tputopo_torch.model) against the JAX package's
``forward`` on the same parameters, converted leaf for leaf."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import to_torch
from tputopo.workloads import model as jm
from tputopo_torch import model as tm

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the reference's own model-level tolerance (tests/test_attention.py).
# bf16: the two frameworks round activations to bf16 at slightly different
# points (fused vs separate elementwise ops); logits reach |x| ~ 4, where a
# bf16 ulp is 2**-6, and the bound is 8 such ulps.
TOL = {"float32": 2e-4, "bfloat16": 0.125}


def _pair(dtype: str, **kw):
    jdt, tdt = DTYPES[dtype]
    return (jm.ModelConfig(**BASE, compute_dtype=jdt, **kw),
            tm.ModelConfig(**BASE, compute_dtype=tdt, **kw))


@pytest.mark.parametrize("dtype,attn_impl", [
    ("float32", "einsum"), ("float32", "flash"), ("float32", "auto"),
    ("bfloat16", "einsum"), ("bfloat16", "flash"),
])
def test_forward_matches_jax(dtype, attn_impl):
    jcfg, tcfg = _pair(dtype, attn_impl=attn_impl)
    params = jm.init_params(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, BASE["vocab_size"], (2, 32))
    ref = np.asarray(jm.forward(params, jnp.asarray(tokens), jcfg))
    out = tm.forward(to_torch(params), torch.from_numpy(tokens), tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 32, BASE["vocab_size"])
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_auto_resolves_einsum_on_cpu_and_flash_on_cuda():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    auto = tm.ModelConfig(attn_impl="auto")
    assert tm._use_flash(auto, 128, cpu) is False
    assert tm._use_flash(auto, 128, gpu) is True
    assert tm._use_flash(auto, 2048, gpu) is True
    # the reference's shape rule: full 128 blocks only
    assert tm._use_flash(auto, 64, gpu) is False
    assert tm._use_flash(auto, 200, gpu) is False
    assert tm._use_flash(tm.ModelConfig(attn_impl="einsum"), 128, gpu) is False
    assert tm._use_flash(tm.ModelConfig(attn_impl="flash"), 64, cpu) is True
    with pytest.raises(ValueError, match="attn_impl=flash needs"):
        tm._use_flash(tm.ModelConfig(attn_impl="flash"), 12, cpu)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tm._use_flash(tm.ModelConfig(attn_impl="bogus"), 128, cpu)


def test_config_mirrors_reference():
    # the port's latent attention (mla) has no counterpart in the reference
    skip = {"compute_dtype", "moe", "mla"}
    for jc, tc in [(jm.ModelConfig(), tm.ModelConfig()),
                   (jm.ModelConfig.llama3_8b(), tm.ModelConfig.llama3_8b()),
                   (jm.ModelConfig.tiny(d_model=64), tm.ModelConfig.tiny(d_model=64))]:
        jf = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
        tf = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
        assert jf.keys() == tf.keys() - {"mla"} and tc.mla is None
        assert {k: v for k, v in jf.items() if k not in skip} == \
               {k: v for k, v in tf.items() if k not in skip}
        assert tc.head_dim == jc.head_dim
    assert tm.ModelConfig().compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown sp_impl"):
        tm.ModelConfig(sp_impl="bogus")


def test_init_params_layout_matches_reference():
    jcfg, tcfg = _pair("float32")
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jm.init_params(jcfg, k), jax.random.key(0)))
    params = tm.init_params(tcfg, 0, device="cpu")
    tshapes = {k: ({n: tuple(w.shape) for n, w in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in params.items()}
    assert tshapes == jshapes
    assert all(w.dtype == torch.float32 for w in params["layers"].values())
    again = tm.init_params(tcfg, 0, device="cpu")
    assert torch.equal(params["embed"], again["embed"])
    assert not torch.equal(params["embed"],
                           tm.init_params(tcfg, 1, device="cpu")["embed"])


def test_unported_features_raise():
    _, tcfg = _pair("float32")
    params = tm.init_params(tcfg, 0, device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.long)
    # MoE layers are ported (tests/test_torch_moe.py): the expert tables
    # take the dense FFN's place
    from tputopo_torch.moe import MoEConfig

    moe = tm.init_params(dataclasses.replace(tcfg, moe=MoEConfig(n_experts=2)), device="cpu")
    assert "moe" in moe["layers"] and "w_gate" not in moe["layers"]
    # LoRA leaves are ported (tests/test_torch_lora.py): a zero-b adapter
    # leaves the forward as it is
    wq = params["layers"]["wq"]
    lora = {"lora_base": wq, "lora_a": torch.ones(wq.shape[:-1] + (2,)),
            "lora_b": torch.zeros((wq.shape[0], 2, wq.shape[-1])),
            "lora_scale": torch.ones(wq.shape[0])}
    assert torch.equal(
        tm.forward(dict(params, layers=dict(params["layers"], wq=lora)), tokens, tcfg),
        tm.forward(params, tokens, tcfg))
    with pytest.raises(ValueError, match="unknown remat"):
        tm.forward(params, tokens, dataclasses.replace(tcfg, remat="bogus"))


def test_out_of_range_token_ids_raise():
    _, tcfg = _pair("float32")
    params = tm.init_params(tcfg, 0, device="cpu")
    for bad in (-1, BASE["vocab_size"]):
        with pytest.raises(ValueError, match="token ids"):
            tm.forward(params, torch.full((1, 16), bad), tcfg)
