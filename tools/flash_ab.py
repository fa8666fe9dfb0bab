#!/usr/bin/env python3
"""Time one flash-attention kernel of two source trees on one GPU.

    python3 tools/flash_ab.py KERNEL OTHER_TREE

``KERNEL`` is ``fwd``, ``dq`` or ``dkv``.  ``OTHER_TREE`` is a checkout of
another commit (``git archive`` unpacked into a directory).  Both trees'
source of the kernel (``tputopo_torch/csrc/*.cu``, with the headers beside
it) are built with the same ``nvcc`` flags and launched through their C
entry points on the same inputs at the model's shape (B·N 32, S 2048, H 128,
bf16, causal), in turns: other, this, this, other.  A turn is the median of
5 runs of 20 back-to-back launches between two CUDA events.  Prints one JSON
line per turn, one line with the outputs' max abs and norm-relative
differences (this against other), and the card's ``nvidia-smi`` line.
Exits 1 if the outputs disagree: where the kernel's source and every
``*.cuh`` beside it are byte-identical in the two trees, unless they are
bitwise equal; otherwise, where an output's ‖this − other‖ / ‖other‖ exceeds
the bf16 bound of ``chip_smoke.py`` (``BWD_BF16_NORM_REL``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import BWD_BF16_NORM_REL, cuda_ms  # noqa: E402
from tputopo_torch import _kernels  # noqa: E402
from tputopo_torch import attention as att  # noqa: E402

THIS = {"fwd": _kernels.FLASH_FWD, "dq": _kernels.FLASH_DQ, "dkv": _kernels.FLASH_DKV}
OUTPUTS = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}


def same_source(this_src: Path, other_src: Path) -> bool:
    """Whether the kernel's source and every header beside it are
    byte-identical in the two trees (a header missing on one side differs)."""
    names = {this_src.name} | {h.name for d in (this_src.parent, other_src.parent)
                               for h in d.glob("*.cuh")}
    a, b = this_src.parent, other_src.parent
    return all((a / f).is_file() and (b / f).is_file()
               and (a / f).read_bytes() == (b / f).read_bytes() for f in names)


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in THIS or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    which, this = sys.argv[1], THIS[sys.argv[1]]
    other_src = Path(sys.argv[2]).resolve() / "tputopo_torch" / "csrc" / this.source.name
    # the same entry name; the library's name hashes the source and the headers
    # beside it, so another tree's source builds into its own file
    kernels = {"other": _kernels.Kernel(this.name, str(other_src), this.n_ptrs),
               "this": this}

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, N, H = 1, 2048, 32, 128
    q, k, v, do = (torch.randn((B, S, N, H), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = att._flash_forward_lse_plain(q, k, v, causal=True)
    d = att._flash_d(o, do)
    inputs = (q, k, v) if which == "fwd" else (q, k, v, do, lse, d)
    outs = {}
    for name in kernels:
        outs[name] = tuple(torch.empty((B * N, S), device="cuda") if o_name == "lse"
                           else torch.empty_like(q) for o_name in OUTPUTS[which])

    def run(name):
        fn = kernels[name].entry()
        ptrs = [t.data_ptr() for t in (*inputs, *outs[name])]
        err = fn(*ptrs, B, S, N, H, 1, 1, 1.0 / H ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kernels[name].name}: cudaError {err}")

    for name in kernels:
        run(name)
    torch.cuda.synchronize()
    diff = {}
    for o_name, a, b in zip(OUTPUTS[which], outs["this"], outs["other"]):
        a, b = a.float(), b.float()
        diff[o_name] = {"max_abs": (a - b).abs().max().item(),
                        "norm_rel": ((a - b).norm() / b.norm()).item()}
    equal = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))
    identical = same_source(this.source, other_src)
    ok = equal if identical else all(x["norm_rel"] <= BWD_BF16_NORM_REL for x in diff.values())

    for turn, name in enumerate(("other", "this", "this", "other")):
        ms = cuda_ms(lambda: run(name))
        print(json.dumps({"kernel": which, "turn": turn, "tree": name, "kernel_ms": ms,
                          "source": str(kernels[name].source)}), flush=True)
    print(json.dumps({"kernel": which, "sources_identical": identical,
                      "outputs_bitwise_equal": equal, "difference": diff,
                      "bound": "bitwise" if identical else {"norm_rel": BWD_BF16_NORM_REL},
                      "within": ok}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
