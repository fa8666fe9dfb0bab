"""The latent chunk-attention kernel, ``csrc/latent_chunk_attn.cu``, and its
place in ``attention.cached_latent_attention``.

A prefill chunk's latent attention (more than 16 queries a row, the
expanded form) goes to the kernel when the code can see that it takes the
call (CUDA, bf16 queries and cache, DeepSeek-V3's head widths) and to the
plain ``attention.latent_expanded`` otherwise: the CPU, an f32 model, other
widths.  Held here on the CPU: that rule, the wrapper's refusals and a
sound call's arguments against the C entry, and the launch count a traced
engine exports, on an MLA engine whose chunk programs reach a stand-in of
the kernel.  The kernel itself runs only on the card: the ``cuda`` cases
below (``python -m pytest --noconftest -m cuda
tests/test_torch_latent_chunk_attention.py`` there) and ``chip_smoke.py``'s
``mla`` phase."""

import dataclasses
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_csrc import c_params
from test_torch_decode_attention import _StandInPrograms
from perfbench.harness import deepseek as ds
from tputopo_torch import _kernels, mla, obs
from tputopo_torch import attention as att
from tputopo_torch import model as tm
from tputopo_torch import serving as ts

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
CUDA, CPU = torch.device("cuda"), torch.device("cpu")
V3 = mla.MLAConfig.deepseek_v3()
# A DeepSeek-V3 layout at a tiny size (test_torch_mla.py's, which this file
# does not import: that one needs JAX, and this one runs on the card): hidden
# 64, 4 heads, ranks 32/16, nope/rope/v 8/4/8, 16 experts in 4 groups, one
# dense and two expert layers, 4 experts held.
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 4, "v_head_dim": 8, "rope_theta": 10000,
        "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 32,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1},
        "rms_norm_eps": 1e-6, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "intermediate_size": 96, "moe_intermediate_size": 32, "n_shared_experts": 1,
        "router_experts": 16, "n_routed_experts": 4, "experts_held": [4, 8],
        "n_group": 4, "topk_group": 2, "num_experts_per_tok": 4,
        "routed_scaling_factor": 2.5, "norm_topk_prob": True, "scoring_func": "sigmoid",
        "topk_method": "noaux_tc", "vocab_size": 128, "max_position_embeddings": 512,
        "router_bias_std": 0.05}
# Elementwise, the flash forward's bf16 tolerance (``chip_smoke.TOL``): the
# kernel and the plain version round P to bf16 from f32 exponentials taken
# against other running maxima (a 128-position tile's, a 1024-position
# block's), so a probability may land one bf16 ulp (2^-8 relative) apart,
# and each output is rounded to bf16 once (one more ulp).
OUT_TOL = 1.6e-2
# A query head's 128 outputs, ||kernel - plain|| / ||plain||: those ulps
# are independent over the positions a query attends and average out, so
# the norm stays within a few times 2^-9; 1e-2 as ``chip_smoke.CHUNK_ROW_REL``
# for chunk_attn.cu.  The elementwise tolerance is as large as the outputs
# themselves over long spans (averages of many unit-normal value rows),
# which this limit is not: a dropped tile, the diagonal off by one and P
# rounded to e4m3 each read above it (test_the_limit_catches_each_fault).
LATENT_ROW_REL = 1e-2


def _stand_in(shape, dtype=BF16, device=CUDA):
    """A tensor as ``latent_kernel_takes`` sees it: a device, a dtype and a
    shape (CUDA tensors cannot be made here)."""
    return SimpleNamespace(shape=shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case,want", [
    ("prefill_chunk", True), ("seventeen", True),
    ("decode", False), ("sixteen", False), ("cpu", False), ("f32_queries", False),
    ("f32_cache", False), ("tiny_widths", False), ("other_rope", False),
])
def test_the_rule_takes_bf16_prefill_chunks_at_deepseeks_widths(case, want):
    T = {"seventeen": 17, "decode": 1, "sixteen": att.LATENT_ABSORBED_T}.get(case, 2048)
    q = _stand_in((1, T, 128, 128), F32 if case == "f32_queries" else BF16,
                  CPU if case == "cpu" else CUDA)
    latent = _stand_in((1, 32768, 576), F32 if case == "f32_cache" else BF16)
    m = {"tiny_widths": ds.model_config(TINY).mla,
         "other_rope": dataclasses.replace(V3, rope=32)}.get(case, V3)
    assert att.latent_kernel_takes(q, latent, m) is want


def _latent_call(B=2, T=20, S=300, N=2, m=V3, dtype=BF16, seed=0):
    """A latent attention call at ``m``'s widths with N heads on the CPU:
    (q_nope, q_pe, latent, pos, kv_b)."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dtype)

    return (randn(B, T, N, m.nope), randn(B, T, N, m.rope), randn(B, S, m.row),
            torch.tensor([0, S - T])[:B], randn(m.kv_rank, N * (m.nope + m.v),
                                                 scale=m.kv_rank ** -0.5))


@pytest.mark.parametrize("takes,T,span", [(True, 20, 120), (True, 20, None), (False, 20, 120),
                                          (True, att.LATENT_ABSORBED_T, None)])
def test_cached_latent_attention_sends_what_the_rule_takes_to_the_kernel(takes, T, span,
                                                                          monkeypatch):
    """Where the rule holds, the kernel's wrapper gets the very tensors and
    the span, and its output is the answer; else the plain forms run, the
    expanded one through ``attention.latent_expanded`` (the CPU's route);
    the absorbed form is never asked about."""
    q_nope, q_pe, latent, _, kv_b = _latent_call(B=1, T=T, m=ds.model_config(TINY).mla)
    m = ds.model_config(TINY).mla
    pos = torch.tensor([100])
    calls, taken, asked = [], [], []
    out = torch.full((1, T, 2, m.v), 7.0)
    monkeypatch.setattr(att, "latent_kernel_takes", lambda *a: asked.append(a) or takes)
    monkeypatch.setattr(att, "_latent_chunk_attention_cuda",
                        lambda *a: calls.append(a) or out)
    for name in ("latent_absorbed", "latent_expanded"):
        form = getattr(att, name)
        monkeypatch.setattr(att, name, lambda *a, form=form, name=name:
                            taken.append(name) or form(*a))
    got = att.cached_latent_attention(q_nope, q_pe, latent, pos, kv_b, m, span)
    if T <= att.LATENT_ABSORBED_T:
        assert not asked and not calls and taken == ["latent_absorbed"]
        return
    assert [a[0] for a in asked] == [q_nope]
    if takes:
        assert got is out and not taken
        assert all(a is b for a, b in zip(calls[0], (q_nope, q_pe, latent, pos, kv_b, m)))
        assert calls[0][6] == span
    else:
        assert not calls and taken == ["latent_expanded"]


def _operands(B=2, T=20, S=300, span=280, N=2, R=512):
    """The kernel's operands, sound: (q, kv, latent, pos, out, span)."""
    q = torch.zeros(B, T, N, 192, dtype=BF16)
    kv = torch.zeros(B, span, N, 256, dtype=BF16)
    latent = torch.zeros(B, S, R + 64, dtype=BF16)
    return q, kv, latent, torch.tensor([0, 7])[:B], torch.zeros(B, T, N, 128, dtype=BF16), span


def _refused(what):
    q, kv, latent, pos, out, span = _operands()
    if what == "q_dtype":
        q = q.float()
    elif what == "kv_dtype":
        kv = kv.float()
    elif what == "latent_dtype":
        latent = latent.float()
    elif what == "out_dtype":
        out = out.float()
    elif what == "q_width":
        q = torch.zeros(2, 20, 2, 160, dtype=BF16)
    elif what == "kv_width":
        kv = torch.zeros(2, span, 2, 192, dtype=BF16)
    elif what == "out_width":
        out = torch.zeros(2, 20, 2, 64, dtype=BF16)
    elif what == "kv_rows":
        kv = kv[:, :-1].contiguous()
    elif what == "latent_rows":
        latent = latent[:1]
    elif what == "rank":
        latent = torch.zeros(2, 300, 500 + 64, dtype=BF16)
    elif what == "span_past_S":
        span, kv = 301, torch.zeros(2, 301, 2, 256, dtype=BF16)
    elif what == "span_zero":
        span, kv = 0, torch.zeros(2, 0, 2, 256, dtype=BF16)
    elif what == "strided_kv":
        kv = torch.zeros(2, span, 4, 256, dtype=BF16)[:, :, :2]
    elif what == "strided_latent":
        latent = torch.zeros(2, 600, 576, dtype=BF16)[:, ::2]
    elif what == "misaligned_q":
        q = torch.zeros(q.numel() + 1, dtype=BF16)[1:].view(q.shape)
    elif what == "pos_dtype":
        pos = pos.int()
    elif what == "pos_shape":
        pos = pos[:1]
    return q, kv, latent, pos, out, span


@pytest.mark.parametrize("what,match", [
    ("q_dtype", "bfloat16"), ("kv_dtype", "bfloat16"), ("latent_dtype", "bfloat16"),
    ("out_dtype", "bfloat16"), ("q_width", "takes q"), ("kv_width", "kv must be"),
    ("out_width", "out must be"), ("kv_rows", "kv must be"), ("latent_rows", "latent cache"),
    ("rank", "multiple of 8"), ("span_past_S", "span 301"), ("span_zero", "span 0"),
    ("strided_kv", "contiguous"), ("strided_latent", "contiguous"),
    ("misaligned_q", "16-byte boundary"), ("pos_dtype", "int64"), ("pos_shape", "int64"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    with pytest.raises(ValueError, match=match):
        att._latent_chunk_launch_args(*_refused(what))


def test_wrapper_refuses_a_span_past_the_cache_before_any_work(monkeypatch):
    q_nope, q_pe, latent, pos, kv_b = _latent_call()
    monkeypatch.setattr(torch, "matmul", None)  # no up-projection is attempted
    for span in (0, 301):
        with pytest.raises(ValueError, match=f"span {span}"):
            att._latent_chunk_attention_cuda(q_nope, q_pe, latent, pos, kv_b, V3, span)


def test_c_signature_matches_the_kernels_argtypes():
    symbol, params = c_params(_kernels.LATENT_CHUNK_ATTN.source)
    assert symbol == _kernels.LATENT_CHUNK_ATTN.symbol == "tputopo_latent_chunk_attn"
    assert [k for k, _ in params] == ["pointer"] * 5 + ["int"] * 6 + ["float", "pointer"]
    assert [n for _, n in params] == ["q", "kv", "latent", "pos", "out",
                                      *_kernels.LATENT_CHUNK_ATTN.ints, "scale", "stream"]
    assert _kernels.LATENT_CHUNK_ATTN in _kernels.KERNELS


def test_limits_match_the_source():
    """The rule's widths are the source's compiled ones."""
    src = _kernels.LATENT_CHUNK_ATTN.source.read_text()
    for name, value in (("NOPE", att.LATENT_NOPE), ("ROPE", att.LATENT_ROPE),
                        ("VDIM", att.LATENT_V)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)


@pytest.mark.parametrize("span", [280, None])
def test_a_sound_call_passes_the_c_parameters_in_order(span, monkeypatch):
    """The wrapper folds the softmax scale into [q_nope, q_pe] before one
    bf16 rounding, up-projects the rows below the span with the plain
    version's bf16 product, and passes the C entry its pointers and ints in
    order; the cache goes in whole (its k_pe read in place)."""
    B, T, S, N = 2, 20, 300, 2
    q_nope, q_pe, latent, pos, kv_b = _latent_call(B, T, S, N)
    seen = {}
    checked = att._latent_chunk_launch_args

    def record(q, kv, lat, p, out, sp):
        seen.update(q=q, kv=kv, latent=lat, pos=p, out=out)
        return checked(q, kv, lat, p, out, sp)

    def call(kern, args, device, what):
        assert kern is _kernels.LATENT_CHUNK_ATTN and device == q_nope.device
        seen["args"] = args

    monkeypatch.setattr(att, "_latent_chunk_launch_args", record)
    monkeypatch.setattr(att, "_call", call)
    got = att._latent_chunk_attention_cuda(q_nope, q_pe, latent, pos, kv_b, V3, span)
    rows = S if span is None else span
    _, params = c_params(_kernels.LATENT_CHUNK_ATTN.source)
    names = [n for _, n in params[:-1]]
    ints = {"B": B, "T": T, "S": S, "span": rows, "N": N, "R": V3.kv_rank}
    assert list(seen["args"]) == ([seen[n].data_ptr() for n in names[:5]]
                                  + [ints[n] for n in names[5:11]] + [1.0])
    assert seen["latent"] is latent and seen["pos"] is pos and got is seen["out"]
    assert got.shape == (B, T, N, V3.v) and got.dtype == BF16
    want_q = (torch.cat([q_nope, q_pe], -1).float() * mla.softmax_scale(V3)).to(BF16)
    assert torch.equal(seen["q"], want_q)
    for b in range(B):  # the plain block's product, row by row
        want_kv = (latent[b, :rows, :V3.kv_rank] @ kv_b).reshape(rows, N, 256)
        assert torch.equal(seen["kv"][b], want_kv)


# ---- the count a traced engine exports ---------------------------------------

def _latent_stand_in(stand_in: _StandInPrograms, monkeypatch) -> None:
    """The kernel's rule as on the card but for its device, dtype and width
    checks (the prefill chunks), and its wrapper the plain expanded form,
    counted as ``attention._call`` counts a launch (a replay runs no
    wrapper)."""
    def wrapper(q_nope, q_pe, latent, pos, kv_b, m, span=None):
        if stand_in.mode != "replay":
            att._count(_kernels.LATENT_CHUNK_ATTN, q_nope.device)
        rows = latent if span is None else latent[:, :span]
        return att.latent_expanded(q_nope, q_pe, rows, pos, kv_b, m)

    monkeypatch.setattr(att, "latent_kernel_takes",
                        lambda q_nope, latent, m: q_nope.shape[1] > att.LATENT_ABSORBED_T)
    monkeypatch.setattr(att, "_latent_chunk_attention_cuda", wrapper)


def test_traced_engine_exports_latent_chunk_launches(monkeypatch):
    """Every replay of a chunk program (chunks of 24 queries) launches the
    latent kernel once a layer; decode steps take the absorbed form, and
    neither cache kernel is launched."""
    cfg = ds.model_config(TINY)
    stand_in = _StandInPrograms()
    stand_in.install(monkeypatch)
    _latent_stand_in(stand_in, monkeypatch)
    params = ds.make(TINY, 7, CPU)
    tracer = obs.Tracer()
    eng = ts.ServingEngine(params, cfg, slots=2, max_len=96, prompt_pad=(48,),
                           prefill_chunk=24, tracer=tracer)
    for n, k in ((30, 4), (7, 3), (45, 5)):
        eng.submit(list(range(1, n + 1)), max_new=k)
    before = _kernels.LATENT_CHUNK_ATTN.launches
    eng.run()
    out = tracer.export()
    replays = out["programs"]["replays"]
    chunks = replays.get("prefill_chunk", 0) + replays.get("admit_final_chunk", 0)
    assert chunks == eng.metrics["prefill_chunks"] == 5
    want = cfg.n_layers * chunks
    assert out["latent_chunk_attention"] == {"launches": want}
    assert eng.programs.launches[_kernels.LATENT_CHUNK_ATTN.name] == want
    assert _kernels.LATENT_CHUNK_ATTN.launches == before + want
    assert out["chunk_attention"] == out["decode_attention"] == {"launches": 0}
    assert out["mla"]["prefill_calls"] >= want and out["mla"]["decode_calls"] > 0


def test_a_gqa_engine_exports_no_latent_launches(monkeypatch):
    """A GQA config's traced engine carries the count too, at 0."""
    from test_torch_chunk_attention import CFG

    _StandInPrograms().install(monkeypatch)
    tracer = obs.Tracer()
    eng = ts.ServingEngine(tm.init_params(CFG, 0, device="cpu"), CFG, slots=2, max_len=64,
                           prompt_pad=(48,), prefill_chunk=24, tracer=tracer)
    eng.submit(list(range(1, 31)), max_new=3)
    eng.run()
    assert tracer.export()["latent_chunk_attention"] == {"launches": 0}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_call(B, T, S, N, starts, seed, device):
    """DeepSeek-V3's widths on the card: (q_nope, q_pe, latent, pos, kv_b),
    bf16 normal draws, kv_b at N(0, 1/kv_rank) as the benchmark draws it."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(BF16)

    return (randn(B, T, N, V3.nope), randn(B, T, N, V3.rope), randn(B, S, V3.row),
            torch.tensor(starts, device=device),
            randn(V3.kv_rank, N * (V3.nope + V3.v), scale=V3.kv_rank ** -0.5))


def _row_rel(got, ref) -> float:
    """The largest ||got - ref|| / ||ref|| over a query head's outputs."""
    diff = got.float() - ref.float()
    return (diff.norm(dim=-1) / ref.float().norm(dim=-1)).max().item()


def _plain(q_nope, q_pe, latent, pos, kv_b, span):
    """The plain expanded form over the rows below ``span`` (None: all)."""
    T = q_nope.shape[1]
    rows, seen = (latent, 0) if span is None else (latent[:, :span], max(span - T, 0))
    return att.latent_expanded(q_nope, q_pe, rows, pos, kv_b, V3, seen)


# (B, T, S, N, starts, span): T 17 and 2048, B 1 and 2; starts at 0, on
# tile edges (6144) and off them (3000, 100), a span (start + T, as the
# chunk programs pass it) whose unmasked bound span - T crosses a tile;
# no span (all S read) with a window past S and a query below 0 (a uniform
# row).
CASES = [
    (1, 17, 300, 128, [0], 17),
    (2, 17, 1000, 128, [127, 1000 - 17], None),
    (1, 2048, 4096, 128, [0], 2048),
    (1, 2048, 8192, 128, [6144], 6144 + 2048),
    (1, 2048, 8192, 128, [3000], 3000 + 2048),
    (2, 2048, 4096, 32, [100, 4096 - 2048], None),
    (2, 300, 1000, 32, [-5, 900], None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,N,starts,span", CASES)
def test_cuda_kernel_matches_the_plain_expanded_form(cuda, B, T, S, N, starts, span):
    """Within OUT_TOL element by element and LATENT_ROW_REL a query head of
    the plain expanded form over the same rows; ``cached_latent_attention``
    takes the kernel, one launch a call."""
    q_nope, q_pe, latent, pos, kv_b = _card_call(B, T, S, N, starts, T + S, cuda)
    before = _kernels.LATENT_CHUNK_ATTN.launches
    got = att.cached_latent_attention(q_nope, q_pe, latent, pos, kv_b, V3, span)
    ref = _plain(q_nope, q_pe, latent, pos, kv_b, span)
    torch.cuda.synchronize()
    assert _kernels.LATENT_CHUNK_ATTN.launches == before + 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), ref.float(), atol=OUT_TOL, rtol=OUT_TOL)
    assert _row_rel(got, ref) <= LATENT_ROW_REL


def _faulted(q_nope, q_pe, latent, pos, kv_b, span, fault):
    """The expanded form computed whole (one softmax over the span's rows)
    with one fault a kernel could make: a 128-position tile dropped (the
    last query tile's diagonal tile), the diagonal off by one (each query
    attends the next position too), or P rounded to e4m3 before P V."""
    B, T, N, _ = q_nope.shape
    R = V3.kv_rank
    kv = (latent[:, :span, :R] @ kv_b).reshape(B, span, N, V3.nope + V3.v)
    k = torch.cat([kv[..., :V3.nope], latent[:, :span, None, R:].expand(-1, -1, N, -1)], -1)
    q = (torch.cat([q_nope, q_pe], -1).float() * mla.softmax_scale(V3)).to(BF16)
    s = torch.einsum("btnd,bsnd->bnts", q.float(), k.float())
    qpos = pos[:, None] + torch.arange(T, device=q.device)
    kpos = torch.arange(span, device=q.device)
    allowed = kpos <= qpos[..., None] + (1 if fault == "diagonal" else 0)
    if fault == "dropped_tile":
        tile = (int(pos[0]) + T - 1) // 128 * 128
        allowed = allowed & ~((kpos >= tile) & (kpos < tile + 128))
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    p = torch.softmax(s, -1)
    p = p.to(torch.float8_e4m3fn if fault == "e4m3" else BF16).float()
    return torch.einsum("bnts,bsnv->btnv", p, kv[..., V3.nope:].float()).to(BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dropped_tile", "diagonal", "e4m3"])
def test_the_limit_catches_each_fault(cuda, fault):
    """Each fault, held against the plain expanded form as the kernel is,
    reads above LATENT_ROW_REL (a chunk of 2048 at start 3000, 32 heads)."""
    T, start = 2048, 3000
    args = _card_call(1, T, 8192, 32, [start], 5, cuda)
    ref = _plain(*args, start + T)
    bad = _faulted(*args, start + T, fault)
    torch.cuda.synchronize()
    assert _row_rel(bad, ref) > LATENT_ROW_REL


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic_and_replays_bit_for_bit(cuda):
    """Two launches give the same bits, and a captured graph's replay the
    same bits as the eager call (the scratch is allocated and freed inside
    the captured body)."""
    T, start = 2048, 2000
    q_nope, q_pe, latent, pos, kv_b = _card_call(1, T, 8192, 128, [start], 9, cuda)

    def call():
        return att.cached_latent_attention(q_nope, q_pe, latent, pos, kv_b, V3, start + T)

    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_cuda_wrapper_rounds_q_as_the_plain_form(cuda, monkeypatch):
    """On the card too, the kernel's q is the plain form's [q_nope, q_pe]
    times the softmax scale, rounded once to bf16, bit for bit."""
    q_nope, q_pe, latent, pos, kv_b = _card_call(1, 256, 1024, 16, [300], 11, cuda)
    seen = {}
    checked = att._latent_chunk_launch_args

    def record(q, *rest):
        seen["q"] = q.clone()
        return checked(q, *rest)

    monkeypatch.setattr(att, "_latent_chunk_launch_args", record)
    att._latent_chunk_attention_cuda(q_nope, q_pe, latent, pos, kv_b, V3, 556)
    want = (torch.cat([q_nope, q_pe], -1).float() * mla.softmax_scale(V3)).to(BF16)
    torch.cuda.synchronize()
    assert torch.equal(seen["q"], want)
