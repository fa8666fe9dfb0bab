"""Token-stream data loading for the training workloads — a copy of
``tputopo/workloads/data.py`` (numpy only; the reference package's
``__init__`` imports JAX, so the port keeps its own copy rather than
importing it).  Equal arguments give equal arrays in both packages.

- **One flat binary file of token ids**, ``np.memmap``'d: no parsing, no
  copies, the OS page cache is the prefetcher.
- **Deterministic disjoint sharding**: sequence windows are a pure function
  of (epoch seed, step, rank), so data-parallel ranks draw disjoint
  batches with no coordination and resume exactly from a checkpointed
  step.  In the port one process drives one GPU, so the data rank is the
  dp coordinate of the process (ranks of one tp group read the same rows).
- **Static shapes**: every batch is ``[batch, seq]`` int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenDataset:
    """A memory-mapped corpus of token ids.

    Args:
        path: flat binary file of token ids.
        dtype: stored integer dtype (``uint16`` for vocab < 65536, the
            common preprocessor choice; any int dtype works).
    """

    path: str
    dtype: str = "uint16"

    def __post_init__(self):
        # Mutable caches on a frozen dataclass: the memmap is opened once,
        # and one epoch's permutation stays resident (regenerating an
        # O(n_windows) shuffle per batch would be exactly the input-
        # pipeline stall this module exists to avoid).
        object.__setattr__(self, "_tokens", None)
        object.__setattr__(self, "_perm_cache", {})

    @property
    def tokens(self) -> np.memmap:
        if self._tokens is None:
            object.__setattr__(
                self, "_tokens",
                np.memmap(self.path, dtype=self.dtype, mode="r"))
        return self._tokens

    def _perm(self, n: int, seed: int, epoch: int) -> np.ndarray:
        key = (n, seed, epoch)
        if key not in self._perm_cache:
            self._perm_cache.clear()  # one epoch resident at a time
            # SeedSequence folds (seed, epoch) independently, so (1, 0)
            # and (0, 1) draw unrelated permutations.
            self._perm_cache[key] = np.random.Generator(
                np.random.Philox(
                    seed=np.random.SeedSequence(entropy=(seed, epoch)))
            ).permutation(n)
        return self._perm_cache[key]

    def __len__(self) -> int:
        return len(self.tokens)

    def n_windows(self, seq: int) -> int:
        """Distinct non-overlapping ``seq``-token windows available."""
        return len(self) // seq

    def batch(self, step: int, batch: int, seq: int, *, rank: int = 0,
              world: int = 1, seed: int = 0) -> np.ndarray:
        """The ``[batch, seq]`` int32 batch for (step, rank).

        Windows are drawn from a per-epoch pseudorandom permutation of
        the non-overlapping window index space, striped
        ``world * batch`` wide per global step — rank r takes stripe
        slot r, so ranks are disjoint within a step BY CONSTRUCTION and
        the whole schedule replays from any checkpointed step.
        """
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} out of range for world {world}")
        n = self.n_windows(seq)
        need = world * batch
        if n < need:
            raise ValueError(
                f"corpus has {n} windows of {seq} tokens; need >= {need} "
                f"(world {world} x batch {batch})")
        steps_per_epoch = n // need
        epoch, estep = divmod(step, steps_per_epoch)
        # Deterministic per-epoch Philox permutation, cached — built once
        # per epoch, sliced per batch.
        order = self._perm(n, seed, epoch)
        base = estep * need + rank * batch
        idx = order[base:base + batch]
        toks = self.tokens
        out = np.empty((batch, seq), np.int32)
        for row, w in enumerate(idx):
            out[row] = toks[w * seq:(w + 1) * seq]
        return out

    def max_token(self, sample: int | None = None) -> int:
        """Max token id — the vocab gate before handing ids to an
        embedding table (an out-of-range id is a wrong row in JAX and a
        device fault on the GPU).  Scans
        the whole corpus by default in one chunked sequential pass; pass
        ``sample`` to bound the check to a prefix explicitly."""
        toks = self.tokens if sample is None else self.tokens[:sample]
        hi = 0
        for start in range(0, len(toks), 1 << 24):
            hi = max(hi, int(toks[start:start + (1 << 24)].max()))
        return hi


def write_tokens(path: str, ids, dtype: str = "uint16") -> None:
    """Write a token id sequence as the flat binary this loader reads
    (test fixtures and small corpora; real corpora come pre-tokenized)."""
    arr = np.asarray(ids)
    if arr.min() < 0 or arr.max() > np.iinfo(dtype).max:
        raise ValueError(
            f"token ids [{arr.min()}, {arr.max()}] do not fit {dtype}")
    arr.astype(dtype).tofile(path)


def steps_per_epoch(ds: TokenDataset, batch: int, seq: int,
                    world: int = 1) -> int:
    return max(1, ds.n_windows(seq) // (world * batch))


def batch_iterator(ds: TokenDataset, batch: int, seq: int, *,
                   start_step: int = 0, rank: int = 0, world: int = 1,
                   seed: int = 0):
    """Infinite iterator of ``[batch, seq]`` int32 arrays from
    ``start_step`` (resume by passing the checkpointed step)."""
    step = start_step
    while True:
        yield ds.batch(step, batch, seq, rank=rank, world=world, seed=seed)
        step += 1
