"""Package contract of the PyTorch port: it imports neither JAX nor the
JAX package, and its entry points run on CUDA unless asked for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tputopo_torch as tt
from tputopo_torch import convert, decode, model, serving

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import tputopo_torch
for m in pkgutil.iter_modules(tputopo_torch.__path__):
    importlib.import_module("tputopo_torch." + m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "tputopo"))
port = sorted(n for n in sys.modules if n.startswith("tputopo_torch."))
print(json.dumps({"bad": bad, "port": port}))
"""


def test_port_imports_no_jax_and_nothing_of_tputopo():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert {"tputopo_torch.quant", "tputopo_torch.serving", "tputopo_torch.distributed",
            "tputopo_torch.collective", "tputopo_torch.linkmodel",
            "tputopo_torch.validate", "tputopo_torch.sharding", "tputopo_torch.data",
            "tputopo_torch.checkpoint", "tputopo_torch.__main__"} <= set(got["port"])


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.ModelConfig(n_layers=1, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.KVCache.create(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.init_state(cfg, 1, 8)
    params = tt.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert model.resolve_device("cpu") == torch.device("cpu")


def test_params_from_numpy_keeps_tree_and_widens_bf16():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1.5, -2.25], dtype=ml_dtypes.bfloat16),
                  "i": np.array([3, 4], dtype=np.int32)}}
    out = convert.params_from_numpy(tree, device="cpu")
    assert out["b"]["c"].dtype == torch.bfloat16
    assert out["b"]["c"].float().tolist() == [1.5, -2.25]
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
    cast = convert.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["i"].dtype == torch.int32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_engine_on_the_card_matches_the_cpu(cuda):
    """A tiny int8 engine, chunked and prefix-cached, gives on the card the
    tokens it gives on the CPU, at f32."""
    cfg = tt.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=64, compute_dtype=torch.float32)
    params = tt.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).tolist() for n in (3, 8, 5)]
    out = []
    for p in (params, {k: (v.to(cuda) if torch.is_tensor(v)
                           else {n: w.to(cuda) for n, w in v.items()})
                       for k, v in params.items()}):
        eng = tt.ServingEngine(tt.quantize_params(p), cfg, slots=2, max_len=24,
                               prompt_pad=8, prefill_chunk=4)
        pid = eng.register_prefix([1, 2, 3])
        ids = [eng.submit(q, max_new=4, prefix=pid if i == 0 else None)
               for i, q in enumerate(prompts)]
        res = eng.run()
        out.append([res[i] for i in ids])
    assert out[0] == out[1]
