"""The port's checkpoints (tputopo_torch.checkpoint, on
torch.distributed.checkpoint): a sharded state saved on one plan restores
onto another exactly, as the reference's test_checkpoint does with orbax;
serving trees, int8 and int4, round-trip bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import run_ranks
from tputopo_torch import checkpoint as ck
from tputopo_torch import model as tm
from tputopo_torch import train as tr
from tputopo_torch.quant import quantize_params

torch.set_num_threads(1)

CFG = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=64, max_seq=32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def across_plans(tmp_path_factory):
    return run_ranks("checkpoint", 4, tmp_path_factory.mktemp("ckpt"))


def test_restore_onto_another_plan_is_exact(across_plans):
    """Saved at {dp: 2, tp: 2} after 3 steps, restored onto {dp: 1, tp: 4}:
    params and both AdamW moments equal, gathered whole."""
    for r in across_plans:
        assert r["equal"] == {"params": True, "mu": True, "nu": True}
        assert r["restored_step"] == [3, 3]  # step and the AdamW count
        assert r["empty"] is None and r["saved"] == 3 and r["latest"] == 3


def test_restored_shards_take_the_new_layout_and_train_on(across_plans):
    L, D, Hd = CFG.n_layers, CFG.d_model, CFG.head_dim
    for r in across_plans:
        assert r["wq_local"] == [L, D, CFG.n_heads * Hd // 4]
        assert r["wk_local"] == [L, D, CFG.n_kv_heads * Hd]  # 2 kv heads, tp 4: whole
        assert r["step_after"] == 4 and np.isfinite(r["loss_after"])


def test_latest_step_and_the_empty_directory(tmp_path):
    assert ck.latest_step(tmp_path / "missing") is None
    assert ck.latest_step(tmp_path) is None
    state = tr.make_train_state(CFG, 0, device="cpu")
    assert ck.restore(tmp_path, state) is None
    for n in (2, 10, 7):
        (tmp_path / f"step_{n}").mkdir()
    (tmp_path / "step_x").mkdir()
    (tmp_path / "params").mkdir()
    assert ck.latest_step(tmp_path) == 10


def test_single_process_state_roundtrips(tmp_path):
    state = tr.make_train_state(CFG, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    state, _ = tr.train_step(state, tokens, CFG)
    assert ck.save(tmp_path, state) == 1
    target = tr.make_train_state(CFG, 5, device="cpu")
    got = ck.restore(tmp_path, target)
    assert int(got.step) == 1 and int(got.opt_state.count) == 1
    for a, b in ((got.params, state.params), (got.opt_state.mu, state.opt_state.mu),
                 (got.opt_state.nu, state.opt_state.nu)):
        for x, y in zip(tr._leaves(a), tr._leaves(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_serving_trees_roundtrip_bit_for_bit(tmp_path, bits):
    params = quantize_params(tm.init_params(CFG, 0, device="cpu"), bits=bits)
    assert ck.restore_params(tmp_path, params) is None
    ck.save_params(tmp_path, quantize_params(tm.init_params(CFG, 1, device="cpu"),
                                             bits=bits))
    ck.save_params(tmp_path, params)  # overwrites the first save in place
    target = quantize_params(tm.init_params(CFG, 9, device="cpu"), bits=bits)
    got = ck.restore_params(tmp_path, target)
    leaves, want = tr._leaves(got), tr._leaves(params)
    assert len(leaves) == len(want)
    for x, y in zip(leaves, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if bits == 4:
        assert got["layers"]["wq"]["int4"].dtype == torch.uint8
