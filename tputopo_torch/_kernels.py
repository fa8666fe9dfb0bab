"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library the first time a
process launches it, and loaded with ``ctypes``.  The library's name
carries a hash of its source and of every ``*.cuh`` header beside it, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA toolkit is needed to build the port's kernels")


FLASH_INTS = ("B", "S", "N", "H", "causal", "dtype")


class Kernel:
    """One ``csrc`` source, its built library and its launch count.

    The source's C entry ``tputopo_<name>`` takes ``n_ptrs`` pointers (the
    tensors), then the ints named by ``ints`` (the flash kernels' B, S, N,
    H, causal and dtype by default), the softmax scale as a float and the
    stream (:attr:`argtypes`).
    ``launches`` is a plain integer that the kernel's wrapper raises by
    one where it launches the kernel, and nowhere else, so a run can show
    that its main path went through the kernel.  A launch that a CUDA
    graph capture records runs only when the graph replays: the wrapper
    counts it in ``captured`` instead, and each replay adds the launches
    its capture recorded to ``launches`` (:mod:`._graphs`)."""

    def __init__(self, name: str, source: str, n_ptrs: int,
                 ints: tuple[str, ...] = FLASH_INTS):
        self.name = name
        self.source = CSRC / source
        self.n_ptrs = n_ptrs
        self.ints = ints
        self.symbol = f"tputopo_{name}"
        self.launches = 0
        self.captured = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None
        self._entry = None

    @property
    def argtypes(self) -> list:
        return ([ctypes.c_void_p] * self.n_ptrs + [ctypes.c_int] * len(self.ints)
                + [ctypes.c_float, ctypes.c_void_p])

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):  # the source's includes
            h.update(header.read_bytes())
        digest = h.hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists."""
        out = self.library_path()
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {self.source.name} "
                               f"(exit {res.returncode}):\n{self.build_log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        return out

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        return self._lib

    def entry(self):
        """The C entry point, its argument and result types set once."""
        if self._entry is None:
            fn = getattr(self.lib(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._entry = fn
        return self._entry


FLASH_FWD = Kernel("flash_fwd", "flash_fwd.cu", n_ptrs=5)          # q k v o lse
FLASH_DQ = Kernel("flash_bwd_dq", "flash_bwd_dq.cu", n_ptrs=7)     # q k v do lse d dq
FLASH_DKV = Kernel("flash_bwd_dkv", "flash_bwd_dkv.cu", n_ptrs=8)  # q k v do lse d dk dv
FLASH = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
# q ck cv pos out part_acc part_ml
DECODE_ATTN = Kernel("decode_attn", "decode_attn.cu", n_ptrs=7,
                     ints=("B", "T", "S", "N", "KV", "H"))
# q ck cv pos out
CHUNK_ATTN = Kernel("chunk_attn", "chunk_attn.cu", n_ptrs=5,
                    ints=("B", "T", "S", "N", "KV", "H"))
# q kv latent pos out (the up-projected rows kv, the cache's k_pe in place)
LATENT_CHUNK_ATTN = Kernel("latent_chunk_attn", "latent_chunk_attn.cu", n_ptrs=5,
                           ints=("B", "T", "S", "span", "N", "R"))
KERNELS = (*FLASH, DECODE_ATTN, CHUNK_ATTN, LATENT_CHUNK_ATTN)
# Instrumentation, not one of the port's kernels: it computes nothing of
# the reference's and replaces no kernel of it, so it lives apart from them
# (``csrc/obs``).  acc, the running sum of the GPU's global timer that a
# tracer reads (the routed expert layer's device time, :mod:`.moe`).
DEVICE_CLOCK = Kernel("device_clock", "obs/device_clock.cu", n_ptrs=1, ints=("sign",))


class LibraryCall:
    """A kernel the port launches through PyTorch's own library rather
    than from ``csrc``, counted as a :class:`Kernel`'s launches are: the
    caller raises ``launches`` by one a launch, or ``captured`` while a CUDA
    graph capture records it, and each replay adds what its capture
    recorded (:mod:`._graphs`)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.captured = 0


# torch._grouped_mm, the routed expert layer's products (:mod:`.moe`)
GROUPED_MM = LibraryCall("grouped_mm")
# Everything whose launches a capture counts.
COUNTED = (*KERNELS, GROUPED_MM)


def build_all() -> None:
    """Build every kernel at once, one ``nvcc`` process per source."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(Kernel.build, KERNELS))  # re-raises a failed build
