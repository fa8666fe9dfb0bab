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
from tputopo_torch import convert, decode, model

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
print(json.dumps(bad))
"""


def test_port_imports_no_jax_and_nothing_of_tputopo():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.ModelConfig(n_layers=1, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.KVCache.create(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
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
