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
            "tputopo_torch.checkpoint", "tputopo_torch.__main__",
            "tputopo_torch.speculative", "tputopo_torch.lora",
            "tputopo_torch.vision", "tputopo_torch.moe", "tputopo_torch.pipeline",
            "tputopo_torch.ring", "tputopo_torch.ulysses"} <= set(got["port"])


def test_every_reference_module_is_mirrored_and_no_later_slice_is_left():
    """Each module of tputopo/workloads has its namesake in the port, and
    no source of the port names a later slice of itself."""
    ref = {p.stem for p in (REPO / "tputopo" / "workloads").glob("*.py")}
    port = {p.stem for p in (REPO / "tputopo_torch").glob("*.py")}
    assert len(ref) == 21 and not sorted(ref - port)  # 20 modules and __init__
    for path in sorted((REPO / "tputopo_torch").rglob("*.py")):
        text = path.read_text().lower()
        assert "later slice" not in text and "not ported yet" not in text, path


@pytest.mark.parametrize("module", ["speculative", "lora", "vision", "moe", "pipeline",
                                    "ring", "ulysses"])
def test_port_modules_expose_the_reference_public_names(module):
    """Every public name of the reference module (read from its source, so
    JAX is not imported) is in the port's module."""
    import ast
    import importlib

    src = (REPO / "tputopo" / "workloads" / f"{module}.py").read_text()
    names = {n.name for n in ast.parse(src).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}
    names |= {t.id for n in ast.parse(src).body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name) and not t.id.startswith("_")}
    port = importlib.import_module(f"tputopo_torch.{module}")
    assert names and not sorted(n for n in names if not hasattr(port, n))


@pytest.mark.parametrize("module,want", [
    ("serving", 7), ("decode", 1), ("model", 1)])
def test_port_modules_expose_the_reference_jit_programs(module, want):
    """The serving path's compiled programs keep the reference's names: every
    top-level ``*_jit`` of the reference module (an assignment or a
    decorated function, read from its source) is a function of the port's
    module, whose docstring says it is a CUDA-graph capture."""
    import ast
    import importlib

    src = (REPO / "tputopo" / "workloads" / f"{module}.py").read_text()
    body = ast.parse(src).body
    names = {t.id for n in body if isinstance(n, ast.Assign) for t in n.targets
             if isinstance(t, ast.Name) and t.id.endswith("_jit")}
    names |= {n.name for n in body if isinstance(n, ast.FunctionDef)
              and n.name.endswith("_jit")}
    assert len(names) == want
    port = importlib.import_module(f"tputopo_torch.{module}")
    for name in sorted(names):
        fn = getattr(port, name, None)
        assert callable(fn), name
        assert "CUDA-graph capture" in " ".join(fn.__doc__.split()), name


# The last compiled programs of the reference: its jitted speculative
# functions and the factories whose steps it jits with their state donated.
JITTED = [("speculative", "spec_generate"), ("speculative", "spec_tick"),
          ("speculative", "_draft_prefill"), ("train", "make_sharded_train_step"),
          ("lora", "make_sharded_lora_train_step"), ("vision", "make_vision_train_step")]


@pytest.mark.parametrize("module,name", JITTED)
def test_the_reference_jitted_programs_keep_their_names(module, name):
    """Each name is a ``jax.jit`` program in the reference module (a
    decorated function, or a factory that returns ``jax.jit(...)``, read
    from its source) and a function of the port's module whose docstring
    says it is a CUDA-graph capture."""
    import ast
    import importlib

    src = (REPO / "tputopo" / "workloads" / f"{module}.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    assert "jax.jit" in ast.get_source_segment(src, fn) or any(
        "jax.jit" in ast.get_source_segment(src, d) for d in fn.decorator_list)
    port = getattr(importlib.import_module(f"tputopo_torch.{module}"), name)
    assert callable(port)
    assert "CUDA-graph capture" in " ".join(port.__doc__.split())


class _Captured(Exception):
    pass


def test_a_step_is_a_graphs_program_on_cuda(monkeypatch):
    """On the CUDA path (here with every group taken for NCCL's) each
    factory's step is a donated program of its own ``_graphs.Programs``:
    its first call goes to the donated capture under the step's name."""
    import torch.distributed as dist

    from tputopo_torch import _graphs, lora, sharding, train, vision

    def capture(self, name, *args, **kw):
        raise _Captured(name)

    monkeypatch.setattr(_graphs, "graphed", lambda device: True)
    monkeypatch.setattr(_graphs, "replays", lambda device, groups=(): True)
    monkeypatch.setattr(_graphs.Programs, "_capture_donated", capture)
    cfg = tt.ModelConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                         d_ff=64, max_seq=16, compute_dtype=torch.float32)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        plan = sharding.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        state = train.make_sharded_state(plan, cfg, 0)
        adapter = lora.make_sharded_lora_state(plan, cfg, 1, rank=2)
        vcfg = vision.VisionConfig(image_size=8, widths=(4,), d_hidden=8)
        vparams = vision.init_vision_params(vcfg, 0, device="cpu")
        vstep, opt = vision.make_vision_train_step(None, vcfg)
        steps = {"train_step": (train.make_sharded_train_step(plan, cfg), (state, tokens)),
                 "lora_train_step": (lora.make_sharded_lora_train_step(plan, cfg,
                                                                       adapter.params),
                                     (adapter, state.params, tokens)),
                 "vision_train_step": (vstep, (vparams, opt.init(vparams),
                                               *vision.synthetic_batch(vcfg, 2, 0,
                                                                       device="cpu")))}
        for name, (step, args) in steps.items():
            assert isinstance(step.programs, _graphs.Programs)
            with pytest.raises(_Captured, match=name):
                step(*args)
    finally:
        dist.destroy_process_group()


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
    from tputopo_torch import lora, vision

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lora.init_lora(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.init_vision_params(vision.VisionConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.synthetic_batch(vision.VisionConfig(), 2, 0)
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
