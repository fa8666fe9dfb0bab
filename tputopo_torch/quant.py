"""Weight contraction and row gather for raw weights — the counterpart of
``tputopo/workloads/quant.py``'s raw-weight arms.

A weight here is a plain tensor in the stacked ``[..., in, out]`` layout,
contracted as ``x @ w``.  The reference also accepts quantized
(``{"int8"|"int4", "scale"}``) and LoRA (``{"lora_base", ...}``) leaves;
those arms are ported with the quantization slice, and until then such a
leaf raises instead of being dequantized behind the caller's back.
"""

from __future__ import annotations

import torch

_LATER = ("quantized and LoRA weight leaves are not ported yet: they come "
          "with the quantization slice of tputopo_torch")


def raw_weight(w) -> torch.Tensor:
    """``w`` itself when it is a plain tensor; a wrapped leaf raises."""
    if isinstance(w, dict):
        raise NotImplementedError(f"{_LATER} (got leaf keys {sorted(w)})")
    return w


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with the weight cast to ``x``'s dtype first."""
    return x @ raw_weight(w).to(x.dtype)


def deq_rows(w, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row gather (embedding lookup) from a raw table, at ``dtype``.

    Gathering first and casting the rows equals casting the table and
    then gathering (the cast is elementwise), and reads only the rows."""
    return raw_weight(w)[idx].to(dtype)
