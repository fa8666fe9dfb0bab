#!/usr/bin/env python3
"""Time the flash-attention forward kernel of two source trees on one GPU.

    python3 tools/flash_fwd_ab.py OTHER_TREE

``OTHER_TREE`` is a checkout of another commit (``git archive`` unpacked
into a directory).  Both trees' ``tputopo_torch/csrc/flash_fwd.cu`` are
built with the same ``nvcc`` flags and launched on the same inputs at the
model's shape (B·N 32, S 2048, H 128, bf16, causal), in turns: other,
this, this, other.  Each turn is the median of 20 launches (CUDA events).
Prints one JSON line per turn, whether the two outputs are bitwise equal,
and the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tputopo_torch import _kernels  # noqa: E402


def _launcher(kernel: _kernels.Kernel):
    fn = kernel.lib().tputopo_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]

    def run(q, k, v, o, lse):
        B, S, N, H = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, S, N, H, 1, 1, 1.0 / H ** 0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kernel.name}: cudaError {err}")

    return run


def _median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve() / "tputopo_torch" / "csrc" / "flash_fwd.cu"
    kernels = {"other": _kernels.Kernel("flash_fwd_other", str(other)),
               "this": _kernels.FLASH_FWD}
    run = {name: _launcher(k) for name, k in kernels.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, N, H = 1, 2048, 32, 128
    q, k, v = (torch.randn((B, S, N, H), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    outs = {}
    for name in run:
        o, lse = torch.empty_like(q), torch.empty((B * N, S), device="cuda")
        run[name](q, k, v, o, lse)
        outs[name] = (o, lse)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    for turn, name in enumerate(("other", "this", "this", "other")):
        o, lse = outs[name]
        ms = _median_ms(lambda: run[name](q, k, v, o, lse))
        print(json.dumps({"turn": turn, "tree": name, "kernel_ms": ms,
                          "source": str(kernels[name].source)}), flush=True)
    print(json.dumps({"outputs_bitwise_equal": equal}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
