"""Attention over a KV cache and its kernel, on the CPU.

``attention.cached_attention`` sends a call to ``csrc/decode_attn.cu`` when
the code can see that the kernel takes it (CUDA, a bf16 cache, at most 16
queries per slot, a group and head dim the kernel takes), else to
``csrc/chunk_attn.cu`` where that kernel takes it
(``tests/test_torch_chunk_attention.py``), and keeps the einsums
otherwise.  Held here: that rule, that the serving step and the
one-shot paths (``generate``, ``build_prefix_cache``) reach the same
dispatcher, the wrapper's refusals, the CPU path bit for bit the einsums it
always was, and the launch count a traced engine exports.  The kernel
itself runs only on the card (``chip_smoke.py`` phases ``decode_attn`` and
``generate``, and the ``cuda`` cases below)."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tputopo_torch import _graphs, _kernels, obs
from tputopo_torch import attention as att
from tputopo_torch import decode as td
from tputopo_torch import model as tm
from tputopo_torch import serving as ts
from tputopo_torch.quant import fold_kv_scale, quantize_kv

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
BF16, F32, INT8 = torch.bfloat16, torch.float32, torch.int8
CFG = tm.ModelConfig(vocab_size=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2,
                     d_ff=64, max_seq=64, compute_dtype=torch.float32)


def _old_einsum(q, ck, cv, pos, group, ck_s=None, cv_s=None):
    """The serving step's cache attention as it was before the kernel,
    verbatim."""
    B, T, N, H = q.shape
    KV = ck.shape[2]
    scale = 1.0 / (H ** 0.5)
    qg = q.float().reshape(B, T, KV, group, H) * scale
    s = torch.einsum("btkgh,bskh->bkgts", qg, ck.float())
    if ck_s is not None:
        s = s * fold_kv_scale(ck_s)
    k_pos = torch.arange(ck.shape[1], device=q.device)
    q_pos = pos[:, None] + torch.arange(T, device=q.device)  # [B, T]
    s = torch.where(k_pos <= q_pos[:, None, None, :, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    if cv_s is not None:
        p = p * fold_kv_scale(cv_s)
    out = torch.einsum("bkgts,bskh->btkgh", p, cv.float())
    return out.reshape(B, T, N, H).to(q.dtype)


def _stand_ins(device, cache, T, group=4, H=128, q_dtype=BF16, KV=8):
    """q and a cache layer as ``decode_kernel_takes`` sees them: a device,
    dtypes and shapes (CUDA tensors cannot be made here)."""
    q = SimpleNamespace(device=device, dtype=q_dtype, shape=(2, T, KV * group, H))
    ck = SimpleNamespace(device=device, dtype=cache, shape=(2, 64, KV, H))
    return q, ck


@pytest.mark.parametrize("device,cache,scaled,T,group,H,q_dtype,want", [
    (CUDA, BF16, False, 1, 4, 128, BF16, "decode"),    # the decode step, the draft
    (CUDA, BF16, False, 5, 4, 128, BF16, "decode"),    # the verify block, gamma 4
    (CUDA, BF16, False, 16, 4, 128, BF16, "decode"),   # the widest block it takes
    (CUDA, BF16, False, 17, 4, 128, BF16, "chunk"),    # wider: the chunk kernel
    (CUDA, BF16, False, 128, 4, 128, BF16, "chunk"),   # chat's prefill chunk
    (CUDA, BF16, False, 512, 4, 128, BF16, "chunk"),   # longdoc's prefill chunk
    (CUDA, BF16, False, 6144, 4, 128, BF16, "chunk"),  # a whole-bucket admission
    (CUDA, BF16, False, 17, 3, 128, BF16, "chunk"),    # a group of 3
    (CUDA, INT8, True, 1, 4, 128, BF16, None),         # the int8 cache
    (CUDA, INT8, True, 128, 4, 128, BF16, None),
    (CUDA, F32, False, 1, 4, 128, F32, None),          # an f32 model
    (CUDA, F32, False, 128, 4, 128, F32, None),
    (CUDA, BF16, False, 1, 4, 64, BF16, None),         # a head dim neither takes
    (CUDA, BF16, False, 128, 4, 64, BF16, None),
    (CUDA, BF16, False, 16, 8, 128, BF16, "chunk"),    # 128 queries a KV head
    (CPU, BF16, False, 1, 4, 128, BF16, None),         # the CPU: the plain version
    (CPU, BF16, False, 128, 4, 128, BF16, None),
])
def test_dispatch_rule(device, cache, scaled, T, group, H, q_dtype, want):
    """Which kernel :func:`cached_attention` takes: the decode kernel where
    its rule holds, else the chunk kernel where its rule holds, else none."""
    q, ck = _stand_ins(device, cache, T, group, H, q_dtype)
    ck_s = object() if scaled else None
    decode = att.decode_kernel_takes(q, ck, ck_s, group)
    chunk = att.chunk_kernel_takes(q, ck, ck_s, group)
    assert ("decode" if decode else "chunk" if chunk else None) == want


def _layer(B=3, T=1, S=40, N=8, KV=2, H=16, dtype=BF16, seed=0):
    rng = np.random.default_rng(seed)
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
                 for s in ((B, T, N, H), (B, S, KV, H), (B, S, KV, H)))
    pos = torch.tensor([0, S // 2, S - 1, -1, S + 2][:B])
    return q, ck, cv, pos, N // KV


@pytest.mark.parametrize("T", [1, 4, 16, 128, 512])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
def test_cpu_path_is_the_old_einsum_bit_for_bit(T, dtype):
    q, ck, cv, pos, group = _layer(B=5, T=T, dtype=dtype)
    before = (_kernels.DECODE_ATTN.launches, _kernels.CHUNK_ATTN.launches)
    got = att.cached_attention(q, ck, cv, pos, group)
    assert torch.equal(got, _old_einsum(q, ck, cv, pos, group))
    assert torch.equal(got, att.cached_attention_plain(q, ck, cv, pos, group))
    assert (_kernels.DECODE_ATTN.launches, _kernels.CHUNK_ATTN.launches) == before


def test_cpu_int8_path_is_the_old_einsum_bit_for_bit():
    q, ck, cv, pos, group = _layer(B=4, T=3, dtype=F32)
    (ck8, cks), (cv8, cvs) = quantize_kv(ck), quantize_kv(cv)
    got = att.cached_attention(q, ck8, cv8, pos, group, cks, cvs)
    assert torch.equal(got, _old_einsum(q, ck8, cv8, pos, group, cks, cvs))


def _one_shot(via):
    """The one-shot path ``via`` on a small f32 model -> (its output, the
    (T, pos) of every cache attention it runs): ``generate``'s prefill and
    T = 1 steps, or ``build_prefix_cache``'s one block."""
    params = tm.init_params(CFG, 0, device="cpu")
    if via == "generate":
        prompt = torch.tensor([[1, 5, 9, 2, 7], [3, 3, 8, 1, 4]])
        out = td.generate(params, prompt, CFG, max_new=3)
        want = [(5, [0, 0])] * CFG.n_layers + [
            (1, [5 + i] * 2) for i in range(2) for _ in range(CFG.n_layers)]
        return out, want
    cache = ts.build_prefix_cache(params, CFG, torch.tensor([4, 1, 6, 2, 9, 3]))
    return torch.cat([cache.k, cache.v]), [(6, [0])] * CFG.n_layers


@pytest.mark.parametrize("via,takes", [
    pytest.param(None, True, id="True"), pytest.param(None, False, id="False"),
    pytest.param("generate", True, id="generate-True"),
    pytest.param("generate", False, id="generate-False"),
    pytest.param("build_prefix_cache", True, id="build_prefix_cache-True"),
    pytest.param("build_prefix_cache", False, id="build_prefix_cache-False"),
])
def test_attend_ragged_goes_where_the_rule_says(via, takes, monkeypatch):
    """The kernel's wrapper gets the very tensors, and its output is the
    answer; otherwise it is not called.  ``generate``'s prefill and T = 1
    steps and ``build_prefix_cache`` reach the same dispatcher as the
    serving step, each row at its own position."""
    calls = []
    if via is not None:
        plain, want = _one_shot(via)

        def wrapper(q, ck, cv, pos):  # the einsums, so the path runs on
            calls.append((q.shape[1], pos.tolist()))
            return att.cached_attention_plain(q, ck, cv, pos, CFG.n_heads // CFG.n_kv_heads)

        monkeypatch.setattr(att, "decode_kernel_takes", lambda *a: takes)
        monkeypatch.setattr(att, "_decode_attention_cuda", wrapper)
        got, _ = _one_shot(via)
        assert torch.equal(got, plain)
        assert calls == (want if takes else [])
        return
    q, ck, cv, pos, group = _layer()
    sentinel = torch.zeros_like(q)

    def wrapper(*args):
        calls.append(args)
        return sentinel

    monkeypatch.setattr(att, "decode_kernel_takes", lambda *a: takes)
    monkeypatch.setattr(att, "_decode_attention_cuda", wrapper)
    got = att.cached_attention(q, ck, cv, pos, group)
    if takes:
        assert got is sentinel and len(calls) == 1
        assert all(a is b for a, b in zip(calls[0], (q, ck, cv, pos)))
    else:
        assert not calls and torch.equal(got, _old_einsum(q, ck, cv, pos, group))


def _outputs(q, ck, split=att.DECODE_SPLIT):
    B, T, N, H = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    splits = (B, KV, -(-S // split), T * (N // KV))
    return {"out": torch.empty_like(q), "part_acc": torch.empty((*splits, H)),
            "part_ml": torch.empty((*splits, 2))}


def _refused(what):
    """A kernel call made bad in one way: (q, ck, cv, pos, outputs)."""
    q, ck, cv, pos, _ = _layer(B=3, T=2, S=300, N=8, KV=2, H=128)
    outs = _outputs(q, ck)
    if what == "q_dtype":
        q = q.float()
        outs = _outputs(q, ck)
    elif what == "cache_dtype":
        ck = ck.float()
    elif what == "cache_shape":
        cv = cv[:, :-1]
    elif what == "kv_heads":
        q = torch.zeros(3, 2, 7, 128, dtype=BF16)
        outs = _outputs(q, ck)
    elif what == "too_many_queries":
        q = torch.zeros(3, 17, 8, 128, dtype=BF16)
        outs = _outputs(q, ck)
    elif what == "head_dim":
        q, ck, cv, pos, _ = _layer(B=3, T=2, S=300, N=8, KV=2, H=64)
        outs = _outputs(q, ck)
    elif what == "strided_cache":
        ck = torch.zeros(3, 300, 4, 128, dtype=BF16)[:, :, :2]
    elif what == "misaligned_q":
        flat = torch.zeros(q.numel() + 1, dtype=BF16)
        q = flat[1:].view(q.shape)
    elif what == "pos_dtype":
        pos = pos.int()
    elif what == "pos_shape":
        pos = pos[:2]
    elif what == "scratch":
        outs = _outputs(q, ck, split=att.DECODE_SPLIT * 2)
    return q, ck, cv, pos, outs


@pytest.mark.parametrize("what,match", [
    ("q_dtype", "bfloat16"), ("cache_dtype", "bfloat16"), ("cache_shape", "cache layer"),
    ("kv_heads", "not a multiple"), ("too_many_queries", "T \\* group"),
    ("head_dim", "head dim"), ("strided_cache", "contiguous"),
    ("misaligned_q", "16-byte boundary"), ("pos_dtype", "int64"), ("pos_shape", "int64"),
    ("scratch", "part_acc"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, match):
    q, ck, cv, pos, outs = _refused(what)
    with pytest.raises(ValueError, match=match):
        att._decode_launch_args(q, ck, cv, pos, outs)


def test_wrapper_takes_a_sound_call():
    q, ck, cv, pos, _ = _layer(B=3, T=2, S=300, N=8, KV=2, H=128)
    args = att._decode_launch_args(q, ck, cv, pos, _outputs(q, ck))
    assert args[7:] == (3, 2, 300, 8, 2, 128, 1.0 / 128 ** 0.5)


# ---- the count a traced engine exports ---------------------------------------

class _StandInPrograms:
    """CPU stand-ins of what a capture on the card does, sharing one
    ``mode``: "capture" while a program's body is recorded, "replay" while
    its graph runs it again, where a graph runs the kernels and none of
    their wrappers' host code."""

    def __init__(self):
        self.mode = None

    def capturing(self, device) -> bool:
        return self.mode == "capture"

    def run_as(self, mode, body, inputs):
        self.mode = mode
        try:
            return body(*inputs)
        finally:
            self.mode = None

    def capture(self):
        """``Programs._capture``: the body runs once as a capture records
        it (the wrappers count into ``captured``), what it wrote is put
        back, and the entry keeps the launches it recorded."""
        stand_in = self

        class Graph:
            def __init__(self, body, inputs):
                self.body, self.inputs = body, inputs

            def replay(self):
                stand_in.run_as("replay", self.body, self.inputs)

        def _capture(programs, name, body, device, inputs, mutated, generator, bound_sig):
            static_in = tuple(t.clone() for t in inputs)
            saved = [t.clone() for t in _graphs.tensors(mutated)]
            before = {k: k.captured for k in _kernels.COUNTED}
            outputs = stand_in.run_as("capture", body, static_in)
            for t, s in zip(_graphs.tensors(mutated), saved):
                t.copy_(s)
            programs.captures[name] += 1
            launches = {k: k.captured - n for k, n in before.items() if k.captured != n}
            return _graphs._Entry(bound_sig, Graph(body, static_in), static_in, outputs,
                                  launches, generator)
        return _capture

    def wrapper(self, kernel):
        """A kernel's wrapper: the plain version, counted as
        ``attention._call`` counts a launch (a replay runs no wrapper)."""
        def wrapper(q, ck, cv, pos):
            if self.mode != "replay":
                att._count(kernel, q.device)
            return att.cached_attention_plain(q, ck, cv, pos, q.shape[2] // ck.shape[2])
        return wrapper

    def install(self, monkeypatch):
        """Graph every program through these stand-ins, with both cache
        kernels' rules as on the card (their device, dtype and head-dim
        checks left out) and both wrappers the plain version, counted."""
        monkeypatch.setattr(_graphs, "graphed", lambda device: True)
        monkeypatch.setattr(_graphs, "capturing", self.capturing)
        monkeypatch.setattr(_graphs.Programs, "_capture", self.capture())
        monkeypatch.setattr(att, "decode_kernel_takes",
                            lambda q, ck, ck_s, group: ck_s is None and q.shape[1] <= 16)
        monkeypatch.setattr(att, "chunk_kernel_takes", lambda q, ck, ck_s, group: ck_s is None)
        monkeypatch.setattr(att, "_decode_attention_cuda", self.wrapper(_kernels.DECODE_ATTN))
        monkeypatch.setattr(att, "_chunk_attention_cuda", self.wrapper(_kernels.CHUNK_ATTN))


@pytest.mark.parametrize("steps_per_tick", [1, 2])
def test_traced_engine_exports_decode_launches(steps_per_tick, monkeypatch):
    """Every replay of a decode program launches the decode kernel once a
    layer a step, and so does every admission here (chunks of 4 queries,
    which the decode kernel takes); the chunk kernel is never launched."""
    _StandInPrograms().install(monkeypatch)
    params = tm.init_params(CFG, 0, device="cpu")
    tracer = obs.Tracer()
    eng = ts.ServingEngine(params, CFG, slots=2, max_len=32, prompt_pad=(8,),
                           prefill_chunk=4, steps_per_tick=steps_per_tick, tracer=tracer)
    for n, m in ((5, 4), (7, 3), (3, 5)):
        eng.submit(list(range(1, n + 1)), max_new=m)
    before = _kernels.DECODE_ATTN.launches
    eng.run()
    out = tracer.export()
    name = "decode_step" if steps_per_tick == 1 else "decode_steps"
    replays = out["programs"]["replays"]
    assert replays[name] * steps_per_tick == eng.metrics["decode_steps"] > 0
    admissions = sum(replays.get(n, 0) for n in ("admit", "prefill_chunk", "admit_final_chunk"))
    assert admissions > 0
    want = CFG.n_layers * (steps_per_tick * replays[name] + admissions)
    assert out["decode_attention"] == {"launches": want}
    assert out["chunk_attention"] == {"launches": 0}
    assert eng.programs.launches == {_kernels.DECODE_ATTN.name: want}
    assert _kernels.DECODE_ATTN.launches == before + want


def test_untraced_engine_carries_nothing():
    params = tm.init_params(CFG, 0, device="cpu")
    eng = ts.ServingEngine(params, CFG, slots=2, max_len=32, prompt_pad=(8,))
    eng.submit([1, 2, 3], max_new=2)
    eng.run()
    assert eng.tracer is None and eng.programs.launches == {}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,N,KV,H", [
    (4, 1, 300, 32, 8, 128), (3, 5, 1000, 32, 8, 128), (5, 3, 200, 12, 4, 128),
])
def test_cuda_kernel_matches_the_einsums(cuda, B, T, S, N, KV, H):
    """Within one bf16 ulp of the einsums' output (f32 sums in another
    order), the ulp taken at no less than 2**-8; two launches bit for bit."""
    q, ck, cv, _, group = (x.to(cuda) if torch.is_tensor(x) else x
                           for x in _layer(B, T, S, N, KV, H))
    pos = torch.tensor([0, 255, S - 1, -1, 256][:B], device=cuda)
    before = _kernels.DECODE_ATTN.launches
    got = att._decode_attention_cuda(q, ck, cv, pos)
    again = att._decode_attention_cuda(q, ck, cv, pos)
    ref = att.cached_attention_plain(q, ck, cv, pos, group)
    torch.cuda.synchronize()
    assert _kernels.DECODE_ATTN.launches == before + 2 and torch.equal(got, again)
    _, e = torch.frexp(ref.float().abs().clamp(min=2.0 ** -8))
    assert ((got.float() - ref.float()).abs() <= torch.exp2(e.float() - 8)).all()
