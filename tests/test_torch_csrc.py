"""The C interface of the port's CUDA kernels, checked without ``nvcc``.

Each ``tputopo_torch/csrc/*.cu`` exports one ``extern "C" int tputopo_*``
entry that ``attention._call`` calls through ctypes.  A change to one side
only would pass garbage to the kernel, with nothing to catch it on a machine
without a card.  These tests parse the C declarations and hold them against
the Python side: the argument types set on the entry, and the values
``_launch_args`` passes, parameter by parameter, for each wrapper."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tputopo_torch import _kernels
from tputopo_torch import attention as att

REPO = Path(__file__).resolve().parent.parent
REFERENCE = REPO / "tputopo" / "workloads" / "attention.py"
SOURCES = sorted(_kernels.CSRC.glob("*.cu"))
FLASH_SOURCES = sorted(k.source for k in _kernels.FLASH)
KERNELS = {k.source.name: k for k in _kernels.KERNELS}
CTYPE_KIND = {"c_void_p": "pointer", "c_int": "int", "c_float": "float"}
# The C parameter names that differ from the wrappers' tensor names.
C_NAME = {"dout": "do"}


def c_params(source: Path) -> tuple[str, list[tuple[str, str]]]:
    """(entry name, [(kind, parameter name), ...]) of the source's entry."""
    m = re.search(r'extern "C" int (tputopo_\w+)\(([^)]*)\)', source.read_text())
    assert m, f"{source.name} has no extern \"C\" int tputopo_* entry"
    params = []
    for decl in m.group(2).split(","):
        decl = " ".join(decl.split())
        name = re.search(r"(\w+)$", decl).group(1)
        kind = "pointer" if "*" in decl else decl.split()[0]
        params.append((kind, name))
    return m.group(1), params


def test_every_source_is_a_kernel_and_every_kernel_has_its_source():
    assert [s.name for s in SOURCES] == sorted(KERNELS)
    assert all(k.source.is_file() for k in _kernels.KERNELS)


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.stem)
def test_c_signature_matches_the_argtypes(source):
    kernel = KERNELS[source.name]
    symbol, params = c_params(source)
    assert symbol == kernel.symbol
    assert [kind for kind, _ in params] == [CTYPE_KIND[t.__name__] for t in kernel.argtypes]
    assert params[-1] == ("pointer", "stream")


def _wrapper_call(kernel, monkeypatch, dtype):
    """Run the kernel's wrapper on CPU tensors with ``_launch`` replaced by a
    recorder; returns (the args ``_launch_args`` builds, tensors by name)."""
    B, S, N, H = 2, 48, 3, 40
    gen = torch.Generator().manual_seed(0)
    named = {n: torch.randn((B, S, N, H), generator=gen).to(dtype)
             for n in ("q", "k", "v", "do")}
    named["lse"] = torch.randn((B * N, S), generator=gen)
    named["d"] = torch.randn((B * N, S), generator=gen)
    seen = {}

    def record(kern, tensors, rows, causal, outputs):
        assert kern is kernel
        seen["args"] = att._launch_args(kern, tensors, rows, causal, outputs)
        seen["outputs"] = outputs

    monkeypatch.setattr(att, "_launch", record)
    common = dict(causal=True)
    if kernel is _kernels.FLASH_FWD:
        att._flash_forward_lse_cuda(named["q"], named["k"], named["v"], **common)
    else:
        fn = att._flash_dq_cuda if kernel is _kernels.FLASH_DQ else att._flash_dkv_cuda
        fn(*(named[n] for n in ("q", "k", "v", "do", "lse", "d")), **common)
    named.update(seen["outputs"])
    return seen["args"], named, (B, S, N, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("source", FLASH_SOURCES, ids=lambda s: s.stem)
def test_launch_passes_the_c_parameters_in_order(source, dtype, monkeypatch):
    kernel = KERNELS[source.name]
    args, named, (B, S, N, H) = _wrapper_call(kernel, monkeypatch, dtype)
    expected = {"B": B, "S": S, "N": N, "H": H, "causal": 1,
                "dtype": {torch.float32: 0, torch.bfloat16: 1}[dtype],
                "scale": 1.0 / H ** 0.5}
    want = []
    for kind, name in c_params(source)[1][:-1]:  # the stream is added at the call
        if kind == "pointer":
            want.append(named[C_NAME.get(name, name)].data_ptr())
        else:
            want.append(expected[name])
    assert list(args) == want


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.stem)
def test_header_note_names_the_pallas_kernel_it_replaces(source):
    """A flash source names the Pallas kernel it replaces; a kernel that
    replaces none (the reference's plain code, which XLA fuses) says so and
    names the reference function it computes."""
    note = source.read_text().split("\n\n")[0]
    m = re.search(r"Replaces tputopo/workloads/attention\.py:(\w+)", note)
    if m is None:
        m = re.search(r"Replaces no Pallas kernel.*?Computes\s+"
                      r"tputopo/workloads/(\w+)\.py:(\w+)", note, re.S)
        assert m, f"{source.name}'s header note names no Pallas kernel, nor says it replaces none"
        ref = (REPO / "tputopo" / "workloads" / f"{m.group(1)}.py").read_text()
        assert re.search(rf"^def {m.group(2)}\(", ref, re.M), m.group(2)
        assert "pallas_call" not in ref
    else:
        fn = m.group(1)
        ref = REFERENCE.read_text()
        assert re.search(rf"^def {fn}\(", ref, re.M), fn
        assert re.search(rf"pl\.pallas_call\(\s*functools\.partial\(\s*{fn}\b", ref), fn
    assert "What bounds it on this card" in source.read_text()


@pytest.mark.parametrize("source", sorted(_kernels.CSRC.glob("*.cu*")), ids=lambda s: s.name)
def test_no_warp_level_mma_sync_left(source):
    """Every bf16 body runs its products on wgmma (sm90.cuh); the
    warp-level mma.sync bodies and their helpers are gone."""
    assert "mma.sync" not in source.read_text()


def test_bf16_tensor_off_a_16_byte_boundary_raises():
    """The bf16 kernels read their tiles by TMA, which takes a base address
    on a 16-byte boundary: the wrapper refuses anything else, with no other
    body to fall back on."""
    B, S, N, H = 1, 16, 1, 8
    flat = torch.zeros(B * S * N * H + 1, dtype=torch.bfloat16)
    q = flat[1:].view(B, S, N, H)  # 2 bytes past an aligned allocation
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    k, v = torch.zeros_like(q), torch.zeros_like(q)
    with pytest.raises(ValueError, match="16-byte boundary"):
        att._launch_args(_kernels.FLASH_FWD, {"q": q, "k": k, "v": v}, {}, True,
                         {"o": torch.empty_like(k), "lse": torch.empty(B * N, S)})


# ---- the decode-attention entry ---------------------------------------------

def _decode_call(monkeypatch, B=3, T=2, S=300, N=8, KV=2, H=128):
    """Run the decode wrapper on CPU tensors with ``_call`` replaced by a
    recorder; returns (the args it passes, tensors by C name, the ints)."""
    gen = torch.Generator().manual_seed(1)
    named = {"q": torch.randn((B, T, N, H), generator=gen).to(torch.bfloat16),
             "ck": torch.randn((B, S, KV, H), generator=gen).to(torch.bfloat16),
             "cv": torch.randn((B, S, KV, H), generator=gen).to(torch.bfloat16),
             "pos": torch.tensor([0, S - 1, -1][:B])}
    seen = {}

    def record(kern, args, device, what):
        assert kern is _kernels.DECODE_ATTN and device == named["q"].device
        seen["args"] = args

    monkeypatch.setattr(att, "_call", record)
    named["out"] = att._decode_attention_cuda(named["q"], named["ck"], named["cv"],
                                              named["pos"])
    return seen["args"], named, {"B": B, "T": T, "S": S, "N": N, "KV": KV, "H": H}


def test_decode_launch_passes_the_c_parameters_in_order(monkeypatch):
    args, named, ints = _decode_call(monkeypatch)
    _, params = c_params(_kernels.DECODE_ATTN.source)
    kinds = [kind for kind, _ in params[:-1]]
    assert kinds == ["pointer"] * 7 + ["int"] * 6 + ["float"]
    names = [name for _, name in params[:-1]]
    assert names[:5] == ["q", "ck", "cv", "pos", "out"]
    assert names[7:] == ["B", "T", "S", "N", "KV", "H", "scale"]
    assert list(_kernels.DECODE_ATTN.ints) == names[7:13]
    assert list(args[:5]) == [named[n].data_ptr() for n in names[:5]]
    assert list(args[7:]) == [ints[n] for n in names[7:13]] + [1.0 / ints["H"] ** 0.5]
    assert named["out"].shape == named["q"].shape and named["out"].dtype == torch.bfloat16


def test_chunk_launch_passes_the_c_parameters_in_order(monkeypatch):
    B, T, S, N, KV, H = 2, 40, 300, 12, 4, 128
    gen = torch.Generator().manual_seed(2)
    named = {"q": torch.randn((B, T, N, H), generator=gen).to(torch.bfloat16),
             "ck": torch.randn((B, S, KV, H), generator=gen).to(torch.bfloat16),
             "cv": torch.randn((B, S, KV, H), generator=gen).to(torch.bfloat16),
             "pos": torch.tensor([0, -3])}
    ints = {"B": B, "T": T, "S": S, "N": N, "KV": KV, "H": H}
    seen = {}

    def record(kern, args, device, what):
        assert kern is _kernels.CHUNK_ATTN and device == named["q"].device
        seen["args"] = args

    monkeypatch.setattr(att, "_call", record)
    named["out"] = att._chunk_attention_cuda(named["q"], named["ck"], named["cv"],
                                             named["pos"])
    _, params = c_params(_kernels.CHUNK_ATTN.source)
    assert [kind for kind, _ in params[:-1]] == ["pointer"] * 5 + ["int"] * 6 + ["float"]
    names = [name for _, name in params[:-1]]
    assert names == ["q", "ck", "cv", "pos", "out", *_kernels.CHUNK_ATTN.ints, "scale"]
    assert list(seen["args"]) == ([named[n].data_ptr() for n in names[:5]]
                                  + [ints[n] for n in names[5:11]] + [1.0 / H ** 0.5])
    assert named["out"].shape == named["q"].shape and named["out"].dtype == torch.bfloat16


def test_chunk_limits_match_the_source():
    """The wrapper's group and head-dim limits are the source's numbers."""
    src = _kernels.CHUNK_ATTN.source.read_text()
    assert re.search(r"constexpr int ROWS = (\d+);", src).group(1) == str(att.CHUNK_ROWS)
    assert re.search(r"constexpr int HEAD_DIM = (\d+);", src).group(1) == str(
        att.CHUNK_HEAD_DIM)


def test_decode_scratch_matches_the_sources_split():
    """The wrapper sizes the per-split scratch from ``DECODE_SPLIT``; the
    kernel indexes it by its own ``SPLIT``: they must be one number, as
    must the query and head-dim limits."""
    src = _kernels.DECODE_ATTN.source.read_text()
    assert re.search(r"constexpr int SPLIT = (\d+);", src).group(1) == str(att.DECODE_SPLIT)
    assert re.search(r"constexpr int MAX_Q = (\d+);", src).group(1) == str(
        att.DECODE_MAX_QUERIES)
    assert re.search(r"constexpr int HEAD_DIM = (\d+);", src).group(1) == str(
        att.DECODE_HEAD_DIM)
