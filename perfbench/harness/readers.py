"""Arithmetic the per-layer readers share.  Each reader,
``metrics/<name>.py``, has ``read(rec) -> float | None`` over the traced
run's record and returns None where it finds nothing to read."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12


def idle_percent(rec: dict) -> float | None:
    """100 x (1 - device busy / stretch wall) over the profiled stretch: an
    upper bound, since the wall holds the profiler's own overhead."""
    prof = rec.get("profile")
    if not prof or not prof.get("busy_s") or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def programs(rec: dict, *names: str) -> list:
    return [p for p in rec.get("programs") or () if p["name"] in names]


def decode_ms_per_step(rec: dict) -> float | None:
    ps = programs(rec, "decode_step", "decode_steps")
    steps = sum(p["steps"] or 0 for p in ps)
    return sum(p["ms"] for p in ps) / steps if steps else None


ADMISSIONS = ("admit", "prefill_chunk", "admit_final_chunk")


def prefill_ms_per_ktok(rec: dict) -> float | None:
    ps = programs(rec, *ADMISSIONS)
    toks = sum(p["prompt_tokens"] or 0 for p in ps)
    return sum(p["ms"] for p in ps) / toks * 1e3 if toks else None


def matmul_params(m: dict) -> int:
    """Parameters a token multiplies through (experts: the k it reaches;
    the head included, the embedding lookup not)."""
    D, N, KV, H = (m["hidden_size"], m["num_attention_heads"],
                   m["num_key_value_heads"], m["head_dim"])
    F = m["intermediate_size"]
    attn = D * (N * H + 2 * KV * H) + N * H * D
    if m.get("num_local_experts"):
        ffn = D * m["num_local_experts"] + m["num_experts_per_tok"] * 3 * D * F
    else:
        ffn = 3 * D * F
    return m["num_hidden_layers"] * (attn + ffn) + D * m["vocab_size"]


def attention_flops_per_pair(m: dict) -> float:
    """Forward flops of one (query, key) pair over all layers and heads:
    QK^T and PV, 2 flops a multiply-add each."""
    return 4.0 * m["num_hidden_layers"] * m["num_attention_heads"] * m["head_dim"]
