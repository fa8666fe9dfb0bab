"""The port's all-reduce measurement (tputopo_torch.collective) on 2 and 4
gloo ranks against the JAX package's ``measure_allreduce`` on as many CPU
devices: the same payload accounting and NCCL-tests arithmetic."""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.torch_parity import run_ranks
from tputopo.workloads import collective as jc
from tputopo_torch import collective as tc

torch.set_num_threads(1)

PAYLOAD_MB = 0.5


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    ranks = run_ranks("collective", n, tmp_path_factory.mktemp(f"collective{n}"),
                      {"payload_mb": PAYLOAD_MB})
    ref = jc.measure_allreduce(devices=jax.devices()[:n], payload_mb=PAYLOAD_MB,
                               iters=2, warmup=1)
    return n, ranks, ref


def test_payload_accounting_equals_the_reference(world):
    n, ranks, ref = world
    for r in ranks:
        got = r["result"]
        assert set(got) == set(ref.to_dict())
        assert got["n_devices"] == ref.n_devices == n
        assert got["payload_mb"] == ref.to_dict()["payload_mb"]


def test_busbw_over_algbw_is_the_nccl_tests_ratio(world):
    n, ranks, ref = world
    for r in ranks:
        assert r["busbw_gbps"] / r["algbw_gbps"] == pytest.approx(
            ref.busbw_gbps / ref.algbw_gbps, rel=1e-12)
        assert r["busbw_gbps"] / r["algbw_gbps"] == pytest.approx(2 * (n - 1) / n)


def test_algbw_is_per_rank_bytes_over_time(world):
    n, ranks, _ = world
    elems = int(PAYLOAD_MB * 1e6) // 4 // n * n
    for r in ranks:
        per_rank_bytes = elems // n * 4
        assert r["algbw_gbps"] == pytest.approx(
            per_rank_bytes / (r["time_ms"] / 1e3) / 1e9, rel=1e-9)
        assert r["algbw_gbps"] > 0


def test_mesh_is_row_major_with_one_group_per_axis(world):
    """{dp: n / 2, tp: 2}: ranks laid out row-major in (pp, dp, sp, ep, tp)
    order, tp innermost."""
    n, ranks, _ = world
    dp_size = n // 2
    for rank, r in enumerate(ranks):
        assert r["mesh"] == [[[[[2 * d, 2 * d + 1]]] for d in range(dp_size)]]
        dp, tp = divmod(rank, 2)
        assert r["coords"] == {"pp": 0, "dp": dp, "sp": 0, "ep": 0, "tp": tp}
        assert r["groups"]["tp"] == [2 * dp, 2 * dp + 1]
        assert r["groups"]["dp"] == [tp + 2 * d for d in range(dp_size)]
        assert r["groups"]["pp"] == r["groups"]["sp"] == r["groups"]["ep"] == [rank]


def test_axis_allreduce_reduces_over_one_axis(world):
    """Each per-axis measurement checked its own sum, over that axis's
    group only, before reporting; the accounting is the reference's."""
    n, ranks, _ = world
    for r in ranks:
        for axis, size in (("dp", n // 2), ("tp", 2)):
            got = r["axis"][axis]
            assert got["n_devices"] == size
            assert got["payload_mb"] == 0.25
            assert got["ratio"] == pytest.approx(2 * (size - 1) / size if size > 1 else 1.0)


def test_a_wrong_sum_is_refused():
    per = 8
    good = tc._shard(0, per, torch.float32, "cpu") + tc._shard(1, per, torch.float32, "cpu")
    tc._check_sum(good, [0, 1], per)
    with pytest.raises(RuntimeError, match="wrong sum"):
        tc._check_sum(good, [0, 2], per)
    with pytest.raises(RuntimeError, match="wrong sum"):
        tc._check_sum(good + 1, [0, 1], per)
