"""Arithmetic of latent attention's per-layer readers (DeepSeek's MLA): the
least time of the work the program's ``mla`` counts describe, whatever
implements it, and the model flops a served token costs.

The counts (``tputopo_torch.obs.LatentCounts``) come apart for the absorbed
form (decode) and the expanded one (prefill): calls, query tokens, latent
rows attended (each row's positions up to its last query) and (query,
position) pairs.  The work of a set of calls is the smaller of two counts:

- absorbed: 2 N (2 R + Dr) flops a pair (scores over R + Dr features, values
  over R);
- expanded: 2 N (Dn + Dr + Dv) flops a pair plus the up-projection of each
  row attended, 2 R N (Dn + Dv);

its bytes the rows once (R + Dr bf16 values each), the queries' q (N (Dn +
Dr)) in and their output (N Dv) out.  Its least time is the larger of the
flops at the bf16 peak and the bytes at HBM bandwidth, for each form; summed
over a form's calls, the larger of the sums is at most the sum of the
larger, so a share of it is never over-stated.
"""

from __future__ import annotations

from perfbench.harness.readers import PEAK_BF16_FLOPS, PEAK_BYTES

KINDS = ("decode", "prefill")


def widths(m: dict) -> tuple:
    return (m["num_attention_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"])


def flops(m: dict, rows: float, pairs: float) -> float:
    N, R, Dn, Dr, Dv = widths(m)
    absorbed = 2.0 * N * (2 * R + Dr) * pairs
    expanded = 2.0 * N * (Dn + Dr + Dv) * pairs + 2.0 * R * N * (Dn + Dv) * rows
    return min(absorbed, expanded)


def nbytes(m: dict, queries: float, rows: float) -> float:
    N, R, Dn, Dr, Dv = widths(m)
    return 2.0 * (rows * (R + Dr) + queries * N * (Dn + Dr + Dv))


def least_s(m: dict, counts: dict) -> float:
    """The least time of the calls ``counts`` (an ``mla`` snapshot, or the
    difference of two) describe."""
    total = 0.0
    for kind in KINDS:
        q, rows, pairs = (counts[f"{kind}_{f}"] for f in ("queries", "rows", "pairs"))
        total += max(flops(m, rows, pairs) / PEAK_BF16_FLOPS,
                     nbytes(m, q, rows) / PEAK_BYTES)
    return total


def stretch_delta(rec: dict, group: str) -> dict | None:
    """The growth of every counter of ``group`` over the profiled stretch, or
    None where the record has no snapshots of it."""
    marks = rec.get("stretch_counts") or {}
    a = (marks.get("start") or {}).get(group)
    b = (marks.get("stop") or {}).get(group)
    if not a or not b:
        return None
    return {k: b[k] - a[k] for k in b if k in a}


def token_flops(m: dict) -> float:
    """Model flops of one token's pass through the layers and the head, not
    counting attention over earlier positions: 2 x the parameters it
    multiplies through, the expert layer's routed part at the share of its
    k pairs that fall on the held experts (k x held / router experts)."""
    N, R, Dn, Dr, Dv = widths(m)
    D, Rq = m["hidden_size"], m["q_lora_rank"]
    attn = D * Rq + Rq * N * (Dn + Dr) + D * (R + Dr) + R * N * (Dn + Dv) + N * Dv * D
    dense = 3 * D * m["intermediate_size"]
    Fe, E = m["moe_intermediate_size"], m["router_experts"]
    held = m["num_experts_per_tok"] * m["n_routed_experts"] / E
    moe = D * E + 3 * D * Fe * (m["n_shared_experts"] + held)
    K, L = m["first_k_dense_replace"], m["num_hidden_layers"]
    return 2.0 * (L * attn + K * dense + (L - K) * moe + D * m["vocab_size"])


def pair_flops(m: dict) -> float:
    """Model flops of one (query, attended position) pair over all layers: each
    head's scores over Dn + Dr features and its values over Dv."""
    N, R, Dn, Dr, Dv = widths(m)
    return 2.0 * m["num_hidden_layers"] * N * (Dn + Dr + Dv)
