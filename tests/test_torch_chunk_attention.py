"""The chunk-attention kernel, ``csrc/chunk_attn.cu``, and its place in
``attention.cached_attention``.

A call that the decode-attention kernel does not take (more than 16
queries a row: the prefill chunks, whole-bucket admissions and one-shot
prefills) goes to the chunk kernel when the code can see that it takes it
(CUDA, a bf16 cache and bf16 queries, a group and head dim it takes), and
to the einsums otherwise.  Held here on the CPU: the order of the
dispatch, the wrapper's refusals and a sound call, and the launch count a
traced engine exports, on an engine whose admissions and decode steps
reach stand-ins of both kernels.  The kernel itself runs only on the card:
the ``cuda`` cases below (``python -m pytest --noconftest -m cuda
tests/test_torch_chunk_attention.py`` there) and ``chip_smoke.py``'s
``chunk_attn`` phase."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_decode_attention import _StandInPrograms
from tputopo_torch import _kernels, obs
from tputopo_torch import attention as att
from tputopo_torch import model as tm
from tputopo_torch import serving as ts

torch.set_num_threads(1)

BF16 = torch.bfloat16
CFG = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2,
                     d_ff=64, max_seq=64, compute_dtype=torch.float32)


def _layer(B=3, T=20, S=300, N=8, KV=2, H=128, dtype=BF16, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
                 for s in ((B, T, N, H), (B, S, KV, H), (B, S, KV, H)))
    return q, ck, cv


@pytest.mark.parametrize("decode,chunk,want", [
    (True, True, "decode"), (True, False, "decode"),
    (False, True, "chunk"), (False, False, "plain"),
])
def test_cached_attention_asks_decode_then_chunk_then_plain(decode, chunk, want, monkeypatch):
    """The decode kernel where its rule holds, else the chunk kernel where
    its rule holds, else the einsums; a kernel's wrapper gets the very
    tensors and its output is the answer."""
    q, ck, cv = _layer()
    pos = torch.tensor([0, 150, -3])
    calls, outs = [], {}
    for name in ("decode", "chunk"):
        outs[name] = torch.full_like(q, float(len(outs) + 1))

        def wrapper(*args, name=name):
            calls.append((name, args))
            return outs[name]

        monkeypatch.setattr(att, f"_{name}_attention_cuda", wrapper)
    monkeypatch.setattr(att, "decode_kernel_takes", lambda *a: decode)
    monkeypatch.setattr(att, "chunk_kernel_takes", lambda *a: chunk)
    got = att.cached_attention(q, ck, cv, pos, 4)
    if want == "plain":
        assert not calls
        assert torch.equal(got, att.cached_attention_plain(q, ck, cv, pos, 4))
        return
    assert got is outs[want] and [c[0] for c in calls] == [want]
    assert all(a is b for a, b in zip(calls[0][1], (q, ck, cv, pos)))


def _refused(what):
    """A kernel call made bad in one way: (q, ck, cv, pos, out)."""
    q, ck, cv = _layer()
    pos = torch.tensor([0, 150, -3])
    out = torch.empty_like(q)
    if what == "q_dtype":
        q = q.float()
    elif what == "cache_dtype":
        ck, cv = ck.float(), cv.float()
    elif what == "out_dtype":
        out = out.float()
    elif what == "cache_shape":
        cv = cv[:, :-1]
    elif what == "cache_rows":
        ck, cv = ck[:2], cv[:2]
    elif what == "kv_heads":
        q = torch.zeros(3, 20, 7, 128, dtype=BF16)
        out = torch.empty_like(q)
    elif what == "group":
        q, ck, cv = _layer(N=129 * 2, KV=2)
        out = torch.empty_like(q)
    elif what == "head_dim":
        q, ck, cv = _layer(H=64)
        out = torch.empty_like(q)
    elif what == "strided_cache":
        ck = torch.zeros(3, 300, 4, 128, dtype=BF16)[:, :, :2]
    elif what == "misaligned_q":
        flat = torch.zeros(q.numel() + 1, dtype=BF16)
        q = flat[1:].view(q.shape)
    elif what == "out_shape":
        out = torch.empty(3, 19, 8, 128, dtype=BF16)
    elif what == "pos_dtype":
        pos = pos.int()
    elif what == "pos_shape":
        pos = pos[:2]
    return q, ck, cv, pos, out


@pytest.mark.parametrize("what,match", [
    ("q_dtype", "bfloat16"), ("cache_dtype", "bfloat16"), ("out_dtype", "bfloat16"),
    ("cache_shape", "cache layer"), ("cache_rows", "cache layer"),
    ("kv_heads", "not a multiple"), ("group", "group of at most 128"),
    ("head_dim", "head dim"), ("strided_cache", "contiguous"),
    ("misaligned_q", "16-byte boundary"), ("out_shape", "out must be \\(3, 20"),
    ("pos_dtype", "int64"), ("pos_shape", "int64"),
])
def test_chunk_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    q, ck, cv, pos, out = _refused(what)
    with pytest.raises(ValueError, match=match):
        att._chunk_launch_args(q, ck, cv, pos, out)


@pytest.mark.parametrize("T,N,KV", [(17, 32, 8), (512, 32, 8), (2048, 12, 4), (1, 8, 8)])
def test_chunk_wrapper_takes_a_sound_call(T, N, KV):
    q, ck, cv = _layer(B=2, T=T, S=300, N=N, KV=KV)
    pos, out = torch.tensor([0, -5]), torch.empty_like(q)
    args = att._chunk_launch_args(q, ck, cv, pos, out)
    assert args[:5] == tuple(t.data_ptr() for t in (q, ck, cv, pos, out))
    assert args[5:] == (2, T, 300, N, KV, 128, 1.0 / 128 ** 0.5)


# ---- the count a traced engine exports ---------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_traced_engine_exports_chunk_launches(kv_dtype, monkeypatch):
    """Every replay of an admission program (chunks of 24 queries) launches
    the chunk kernel once a layer, and every decode replay the decode
    kernel; an int8 cache launches neither."""
    cfg = dataclasses.replace(CFG, kv_dtype=kv_dtype)
    _StandInPrograms().install(monkeypatch)
    params = tm.init_params(cfg, 0, device="cpu")
    tracer = obs.Tracer()
    eng = ts.ServingEngine(params, cfg, slots=2, max_len=64, prompt_pad=(48,),
                           prefill_chunk=24, tracer=tracer)
    for n, m in ((30, 4), (7, 3), (45, 5)):
        eng.submit(list(range(1, n + 1)), max_new=m)
    before = _kernels.CHUNK_ATTN.launches
    eng.run()
    out = tracer.export()
    replays = out["programs"]["replays"]
    admissions = replays.get("prefill_chunk", 0) + replays.get("admit_final_chunk", 0)
    assert admissions == eng.metrics["prefill_chunks"] == 5
    want = cfg.n_layers * admissions if kv_dtype == "bf16" else 0
    assert out["chunk_attention"] == {"launches": want}
    assert eng.programs.launches[_kernels.CHUNK_ATTN.name] == want
    assert _kernels.CHUNK_ATTN.launches == before + want
    decode = cfg.n_layers * replays["decode_step"] if kv_dtype == "bf16" else 0
    assert out["decode_attention"] == {"launches": decode}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (B, T, S, N, KV, positions): T 17 / 128 / 512 / 2048, B 1 and 3, group 4
# and 3; starts at 0, at tile edges, at S - T, with a window past S (a raw
# start), below 0 for some queries (the uniform rows) and for all of them.
CASES = [
    (1, 17, 300, 32, 8, [0]),
    (3, 17, 300, 32, 8, [127, 128, -5]),
    (1, 128, 2048, 32, 8, [2048 - 128]),
    (3, 128, 1000, 32, 8, [0, 1000 - 128 + 7, -1]),
    (3, 128, 700, 12, 4, [0, 129, -3]),
    (1, 512, 8192, 32, 8, [3000]),
    (3, 512, 2048, 32, 8, [255, 2048 - 512, -600]),
    (1, 512, 1500, 24, 8, [700]),
    (1, 2048, 4096, 32, 8, [0]),
    (3, 2048, 2560, 32, 8, [128, 512, 2560 - 2048]),
    (1, 40, 100, 32, 8, [60]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,N,KV,positions", CASES)
def test_cuda_kernel_matches_the_plain_version(cuda, B, T, S, N, KV, positions):
    """Within the flash forward's bf16 tolerance of the einsums element by
    element (P is rounded to bf16 before P·V on the kernel's side only),
    and within ``chip_smoke.CHUNK_ROW_REL`` (1e-2) as ||kernel - plain|| /
    ||plain|| over each query head's outputs, which the elementwise
    tolerance, as large as the outputs over long prefixes, is not; two
    launches bit for bit; ``cached_attention`` takes the kernel."""
    q, ck, cv = _layer(B, T, S, N, KV, device=cuda, seed=T + S)
    pos = torch.tensor(positions, device=cuda)
    before = _kernels.CHUNK_ATTN.launches
    got = att._chunk_attention_cuda(q, ck, cv, pos)
    again = att.cached_attention(q, ck, cv, pos, N // KV)
    ref = att.cached_attention_plain(q, ck, cv, pos, N // KV)
    torch.cuda.synchronize()
    assert _kernels.CHUNK_ATTN.launches == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), atol=1.6e-2, rtol=1.6e-2)
    diff = got.float() - ref.float()
    assert (diff.norm(dim=-1) / ref.float().norm(dim=-1)).max().item() <= 1e-2
