"""The numbers a training cell compares with the reference: each step's
loss, the first step's gradient norm per leaf and the norm of each leaf's
change over the steps, each taken by the worst leaf as the gap between the
two sides' norms over the reference's norm of that leaf or of the median
leaf, whichever is larger."""

from __future__ import annotations

import statistics


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``loss`` (per step), ``grad_norm`` and
    ``change_norm`` (per leaf).  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam and
    are left out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    rg, rc = ref["grad_norm"], ref["change_norm"]
    med_g = statistics.median(rg.values())
    grad = {k: abs(prog["grad_norm"][k] - rg[k]) / max(rg[k], med_g) for k in rg}
    moved = [k for k in rc if rg[k] >= 1e-3 * med_g]
    med_c = statistics.median(rc[k] for k in moved)
    change = {k: abs(prog["change_norm"][k] - rc[k]) / max(rc[k], med_c) for k in moved}
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_by_leaf": grad, "change_gap_by_leaf": change,
            "left_out": sorted(set(rc) - set(moved))}
