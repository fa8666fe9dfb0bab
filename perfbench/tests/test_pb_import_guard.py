"""The plain reference loads nothing of the program or of JAX, and a run
that loaded JAX or the JAX package is caught by whole top-level names."""

import subprocess
import sys

from perfbench.harness import common

PROBE = """
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.model
from perfbench.harness import compare, traffic, weights, common
loaded = {{m.split('.')[0] for m in sys.modules}}
print(sorted(loaded & {{'jax', 'jaxlib', 'flax', 'tputopo', 'tputopo_torch'}}))
"""


def test_reference_imports_no_program_and_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(common.ROOT))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_by_whole_top_level_name(monkeypatch):
    assert common.forbidden_loaded() == [] or "tputopo_torch" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "tputopo_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "tputopo.workloads", sys)
    assert common.forbidden_loaded() == ["jax.numpy", "tputopo.workloads"]
