"""The port's mesh planning and parameter layout (tputopo_torch.sharding)
against the JAX package's ``plan_mesh`` and ``param_specs``."""

import dataclasses
import itertools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from tests.torch_parity import world_of_one
from tputopo.workloads import model as jm
from tputopo.workloads import sharding as js
from tputopo_torch import model as tm
from tputopo_torch import sharding as sh

torch.set_num_threads(1)

JCFG = jm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_ff=64, max_seq=32, compute_dtype=jnp.float32)
TCFG = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_ff=64, max_seq=32, compute_dtype=torch.float32)


def _plan_or_error(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


GRID = [dict(n=n, tp=tp, sp=sp, pp=pp, ep=ep, heads=heads)
        for n, tp, sp, pp, ep, heads in itertools.product(
            (1, 2, 3, 4, 6, 8, 16), (None, 1, 2, 4, 3), (None, 1, 2),
            (1, 2), (1, 2), (None, 4, 6, 32))]


def test_axes_are_the_reference_order():
    assert sh.AXES == js.AXES == ("pp", "dp", "sp", "ep", "tp")


def test_plan_mesh_equals_the_reference_over_a_grid():
    """Equal axis sizes, or the same ValueError message, on every row."""
    for row in GRID:
        kw = dict(row)
        n = kw.pop("n")
        assert _plan_or_error(sh.plan_mesh, n, **kw) == \
            _plan_or_error(js.plan_mesh, n, **kw), row


def _ref_specs(axes, config):
    n = 1
    for a in js.AXES:
        n *= axes.get(a, 1)
    plan = js.build_mesh(axes, devices=jax.devices()[:n])
    return jax.tree.map(lambda p: tuple(p), js.param_specs(plan, config),
                        is_leaf=lambda x: isinstance(x, js.P))


@pytest.mark.parametrize("axes", [{"tp": 1}, {"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2},
                                  {"dp": 4, "tp": 2}, {"pp": 2, "tp": 2},
                                  {"pp": 2, "dp": 2, "tp": 2}])
@pytest.mark.parametrize("with_config", [False, True])
def test_param_specs_equal_the_reference(axes, with_config):
    """Axis names per dim, read from the reference's PartitionSpecs: equal
    where tp divides the kv heads (here 4 of them)."""
    plan = sh.MeshPlan(mesh=None, axes=dict(axes))
    got = sh.param_specs(plan, TCFG if with_config else None)
    assert got == _ref_specs(axes, JCFG if with_config else None)
    assert sh.batch_sharding(plan) == tuple(js.batch_sharding(
        js.build_mesh(axes, devices=jax.devices()[:plan_size(axes)])).spec)


def plan_size(axes):
    n = 1
    for v in axes.values():
        n *= v
    return n


def test_gqa_kv_replication_is_the_one_deviation():
    """2 kv heads, tp 4: the reference splits wk/wv (and lets XLA reshard
    a split that cuts heads apart); the port keeps them whole on every
    rank.  Every other leaf is the reference's."""
    jcfg = dataclasses.replace(JCFG, n_kv_heads=2)
    tcfg = dataclasses.replace(TCFG, n_kv_heads=2)
    plan = sh.MeshPlan(mesh=None, axes={"dp": 2, "tp": 4})
    got = sh.param_specs(plan, tcfg)
    ref = _ref_specs({"dp": 2, "tp": 4}, jcfg)
    assert sh.kv_replicated(plan, tcfg)
    assert got["layers"].pop("wk") == got["layers"].pop("wv") == (None, None, None)
    assert ref["layers"].pop("wk") == ref["layers"].pop("wv") == (None, None, "tp")
    assert got == ref
    assert not sh.kv_replicated(sh.MeshPlan(mesh=None, axes={"tp": 2}), tcfg)


def test_constrain_is_the_identity_and_activate_nests():
    x = torch.ones(2, 2)
    assert sh.constrain(x, "dp", None) is x
    a, b = sh.MeshPlan(mesh=None, axes={}), sh.MeshPlan(mesh=None, axes={"dp": 2})
    assert sh.active_plan() is None
    with sh.activate(a):
        with sh.activate(b):
            assert sh.active_plan() is b
        assert sh.active_plan() is a
    assert sh.active_plan() is None


def test_build_mesh_of_one_and_its_errors():
    with world_of_one():
        plan = sh.build_mesh({"dp": 1, "tp": 1}, device="cpu")
        assert plan.mesh.mesh_dim_names == sh.AXES
        assert tuple(plan.mesh.mesh.shape) == (1, 1, 1, 1, 1)
        assert plan.n_devices == 1 and plan.device == torch.device("cpu")
        assert all(plan.rank(a) == 0 for a in sh.AXES)
        assert plan.axes == {"pp": 1, "dp": 1, "sp": 1, "ep": 1, "tp": 1}
        with pytest.raises(ValueError, match="need 2 devices, got 1"):
            sh.build_mesh({"dp": 2}, device="cpu")
        assert sh.mesh_for_slice((1,), device="cpu", heads=4).axes["tp"] == 1
        full = torch.arange(12.0).reshape(3, 4)
        assert torch.equal(sh.local_batch(plan, full), full)
        assert sh.local_batch(plan, full) is not full


def test_shard_leaf_refuses_an_uneven_split():
    plan = sh.MeshPlan(mesh=None, axes={"tp": 4})
    with pytest.raises(ValueError, match="does not split over tp=4"):
        sh.shard_leaf(torch.zeros(2, 6), (None, "tp"), plan)
