"""CPU tests of the benchmark harness.  They need no card, no nvcc and no
triton; tests marked ``cuda`` skip here, decided inside a fixture.  Nothing
here imports JAX."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 256, "max_position_embeddings": 512, "rope_theta": 1e6,
        "rms_norm_eps": 1e-5}
TINY_MOE = dict(TINY, num_local_experts=4, num_experts_per_tok=2,
                router_aux_loss_coef=0.02, capacity_factor=1.25)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips, with its reason, where there is none")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def tiny_cell(name: str, model: dict | None = None) -> dict:
    """The cell ``name`` as committed, on a tiny model and tiny shapes that
    a CPU test run holds."""
    from perfbench.harness.common import workload

    c = copy.deepcopy(workload(name))
    c["model"] = dict(model or TINY)
    if c["driver"] == "train":
        c["traffic_mix"].update(batch=1 if "num_local_experts" in c["model"] else 2, seq=32)
    elif c["driver"] == "serve_open":
        c["engine"].update(max_len=160, prompt_pad=[16, 32, 64], prefill_chunk=16)
        c["traffic_mix"]["prompt"].update(min=4, max=64, median=20)
        c["traffic_mix"]["output"].update(min=2, max=24, median=8)
        c["traffic_mix"]["arrival"]["rate"] = 6
        c["check"] = {"served_tokens": 60, "max_requests": 4}
    else:
        c["engine"].update(slots=4, max_len=200, prompt_pad=[32, 64, 96], prefill_chunk=16)
        c["traffic_mix"]["prompt"].update(min=24, max=96)
        c["traffic_mix"]["output"].update(min=4, max=32, median=8)
        c["backlog"] = 6
        c["check"] = {"served_tokens": 40, "max_requests": 2}
    return c
