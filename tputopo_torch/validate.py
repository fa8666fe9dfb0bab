"""Predicted-vs-measured all-reduce validation and cost-model calibration —
the counterpart of ``tputopo/workloads/validate.py``.

- :func:`validate_slice` runs the real all-reduce
  (:mod:`tputopo_torch.collective`) over the gang's process group and holds
  the measured algorithm bandwidth against the link model's prediction for
  the slice (:mod:`tputopo_torch.linkmodel`): the acceptance number,
  "scheduled slice vs ideal".
- :func:`calibrate_cost_model` backs the per-link GB/s out of a measured
  all-reduce, and the HBM figure out of a measured stream, so deployments
  can replace the spec defaults with measured reality.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from tputopo_torch.collective import AllReduceResult, measure_allreduce
from tputopo_torch.linkmodel import (GpuTopology, LinkCostModel, get_generation,
                                     parse_topology, predict_allreduce_gbps)


@dataclass(frozen=True)
class ValidationReport:
    topology: str
    predicted_gbps: float
    measured: AllReduceResult

    @property
    def measured_gbps(self) -> float:
        return self.measured.algbw_gbps

    @property
    def efficiency(self) -> float:
        """measured / predicted — 1.0 means the model is honest; 0 where
        nothing is predicted (one GPU)."""
        return self.measured_gbps / self.predicted_gbps if self.predicted_gbps else 0.0

    def to_dict(self) -> dict:
        return {
            "topology": self.topology,
            "predicted_gbps": round(self.predicted_gbps, 3),
            "measured_gbps": round(self.measured_gbps, 3),
            "efficiency": round(self.efficiency, 4),
            **{f"measured_{k}": v for k, v in self.measured.to_dict().items()},
        }


def validate_slice(topo: GpuTopology | str, group=None, payload_mb: float = 16.0,
                   iters: int = 10) -> ValidationReport:
    """Measure the all-reduce over ``group`` (default: the whole gang) and
    compare with the model's prediction for the slice ``topo``."""
    if isinstance(topo, str):
        topo = parse_topology(topo)
    cost = LinkCostModel.for_generation(topo.generation.name)
    predicted = predict_allreduce_gbps(topo, topo.dims, cost)
    measured = measure_allreduce(group, payload_mb=payload_mb, iters=iters)
    return ValidationReport(topology=topo.describe(), predicted_gbps=predicted,
                            measured=measured)


def calibrate_cost_model(topo: GpuTopology,
                         measured_algbw_gbps: float | None = None, *,
                         measured_hbm_gbps: float | None = None) -> LinkCostModel:
    """Back out the figures that make the model reproduce measurements
    exactly, keeping the rest of the cost table.

    - ``measured_algbw_gbps`` (an all-reduce over the whole ``topo``) fits
      ``ici_link_gbps``: the prediction is linear in it, so calibration is
      one division.
    - ``measured_hbm_gbps`` (a stream benchmark) replaces ``hbm_gbps``; it
      needs no link, so it calibrates on one GPU too.
    """
    base = LinkCostModel.for_generation(topo.generation.name)
    fields: dict = {}
    if measured_algbw_gbps is not None:
        if measured_algbw_gbps <= 0:
            raise ValueError(
                f"measured_algbw_gbps must be > 0, got {measured_algbw_gbps}"
                " (a differencing artifact?)")
        unit = predict_allreduce_gbps(topo, topo.dims, base) / base.ici_link_gbps
        if unit <= 0:
            raise ValueError(
                f"topology {topo.describe()} has no multi-chip axis to calibrate on")
        fields["ici_link_gbps"] = measured_algbw_gbps / unit
    if measured_hbm_gbps is not None:
        if measured_hbm_gbps <= 0:
            raise ValueError(f"measured_hbm_gbps must be > 0, got {measured_hbm_gbps}")
        fields["hbm_gbps"] = float(measured_hbm_gbps)
    if not fields:
        raise ValueError("nothing to calibrate: pass at least one measurement")
    return dataclasses.replace(base, **fields)


def measured_vs_spec(cal: LinkCostModel, gen_name: str) -> dict:
    """The measured-vs-spec record a deployment carries next to its cost
    override (the generation table stays spec; this documents the delta)."""
    g = get_generation(gen_name)
    out = {}
    for fld, spec in (("ici_link_gbps", g.ici_link_gbps),
                      ("hbm_gbps", g.hbm_gbps),
                      ("dcn_host_gbps", g.dcn_host_gbps)):
        measured = getattr(cal, fld)
        out[fld] = {"spec": spec, "calibrated": round(measured, 1),
                    "calibrated_over_spec": round(measured / spec, 3)}
    return out
