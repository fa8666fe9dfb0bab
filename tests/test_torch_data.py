"""The port's token-corpus loader (tputopo_torch.data) against the JAX
package's: equal arrays for equal arguments, disjoint ranks, the same
errors."""

import numpy as np
import pytest

from tputopo.workloads import data as jd
from tputopo_torch import data as td


@pytest.fixture
def corpus(tmp_path):
    path = str(tmp_path / "tokens.bin")
    td.write_tokens(path, np.random.default_rng(0).integers(0, 1000, 4096))
    return path


def test_written_file_is_the_reference_format(tmp_path):
    ids = np.random.default_rng(1).integers(0, 60000, 777)
    td.write_tokens(str(tmp_path / "a.bin"), ids)
    jd.write_tokens(str(tmp_path / "b.bin"), ids)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    td.write_tokens(str(tmp_path / "c.bin"), ids, "int32")
    jd.write_tokens(str(tmp_path / "d.bin"), ids, "int32")
    assert (tmp_path / "c.bin").read_bytes() == (tmp_path / "d.bin").read_bytes()


# (step, batch, seq, rank, world, seed): step 9 at batch 4 x world 2 rolls
# over into epoch 1 (256 windows of 16 / 8 = 32 steps an epoch for seq 16;
# 4096 / 64 = 64 windows / 8 = 8 steps for seq 64).
ROWS = [(0, 4, 16, 0, 1, 0), (7, 4, 16, 0, 1, 3), (5, 2, 32, 1, 2, 0),
        (9, 4, 64, 1, 2, 0), (9, 4, 64, 0, 2, 0), (40, 4, 16, 3, 4, 7),
        (8, 8, 64, 0, 1, 1), (100, 1, 8, 2, 3, 2), (0, 3, 100, 0, 1, 5)]


@pytest.mark.parametrize("row", ROWS, ids=[str(r) for r in ROWS])
def test_batches_equal_the_reference(corpus, row):
    step, batch, seq, rank, world, seed = row
    got = td.TokenDataset(corpus).batch(step, batch, seq, rank=rank, world=world, seed=seed)
    want = jd.TokenDataset(corpus).batch(step, batch, seq, rank=rank, world=world,
                                         seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_helpers_equal_the_reference(corpus):
    t, j = td.TokenDataset(corpus), jd.TokenDataset(corpus)
    assert len(t) == len(j) == 4096
    assert t.n_windows(16) == j.n_windows(16)
    assert t.max_token() == j.max_token() and t.max_token(100) == j.max_token(100)
    for args in ((4, 16, 1), (4, 16, 2), (8, 64, 4)):
        assert td.steps_per_epoch(t, *args) == jd.steps_per_epoch(j, *args)
    it_t = td.batch_iterator(t, 4, 16, start_step=5, rank=1, world=2, seed=3)
    it_j = jd.batch_iterator(j, 4, 16, start_step=5, rank=1, world=2, seed=3)
    for _ in range(4):
        np.testing.assert_array_equal(next(it_t), next(it_j))


def test_ranks_are_disjoint_within_a_step(corpus):
    ds = td.TokenDataset(corpus)
    for step in (0, 3, 31):
        rows = [tuple(r) for rank in range(4)
                for r in ds.batch(step, 4, 16, rank=rank, world=4)]
        assert len(set(rows)) == len(rows)


@pytest.mark.parametrize("mod", [td, jd], ids=["port", "reference"])
def test_errors_are_the_reference_ones(corpus, tmp_path, mod):
    ds = mod.TokenDataset(corpus)
    with pytest.raises(ValueError, match="rank 2 out of range for world 2"):
        ds.batch(0, 4, 16, rank=2, world=2)
    with pytest.raises(ValueError, match="need >= 8192"):
        ds.batch(0, 4096, 16, world=2)
    with pytest.raises(ValueError, match="do not fit uint16"):
        mod.write_tokens(str(tmp_path / "t.bin"), [0, 70000])
    with pytest.raises(ValueError, match="do not fit"):
        mod.write_tokens(str(tmp_path / "t.bin"), [-1, 3])
