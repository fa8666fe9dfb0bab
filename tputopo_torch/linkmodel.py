"""The link model of an H100 gang — the port's own stand-in for the
``LinkCostModel``, ``parse_topology`` and ``predict_allreduce_gbps`` that the
reference's ``validate.py`` takes from ``tputopo.topology`` (which the port
may not import).

A gang of H100 SXM cards inside one host sits on one NVSwitch fabric: every
card has the same NVLink bandwidth into the switches, and a ring all-reduce
through the switches is bounded by that per-card bandwidth.  The prediction
is the scorer's ring rule (``tputopo/topology/score.py``) for one axis of
``n`` members:

    algbw = link_gbps * n / (2 * (n - 1))     (0 for n = 1)

with ``link_gbps`` the per-card bandwidth in one direction.  A single card
predicts 0, as the reference's box model does for a 1x1x1 slice: there is
no link to measure.

The cost model keeps the reference's field names, so calibration records
(:func:`tputopo_torch.validate.measured_vs_spec`) and the extender's cost
overrides keep their keys.  On an H100, ``ici_link_gbps`` means the
per-GPU NVLink bandwidth into the NVSwitch fabric, one direction.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Generation:
    """Published figures of one GPU part, GB/s."""

    name: str
    ici_link_gbps: float   # NVLink into the switch fabric, per GPU, one direction
    hbm_gbps: float        # device memory bandwidth
    dcn_host_gbps: float   # network out of one host
    max_devices: int       # GPUs in one NVSwitch domain (one host)


GENERATIONS = {
    "h100": Generation(
        name="h100",
        # NVIDIA H100 Tensor Core GPU datasheet, SXM form factor:
        # "NVIDIA NVLink: 900GB/s", the total of both directions over the
        # card's 18 NVLink 4 links -> 450 GB/s each way.
        ici_link_gbps=450.0,
        # The same datasheet: "GPU memory bandwidth 3.35TB/s" (80 GB HBM3).
        hbm_gbps=3350.0,
        # NVIDIA DGX H100 datasheet: 8x single-port ConnectX-7, up to
        # 400 Gb/s each, for the host's 8 GPUs -> 3.2 Tb/s = 400 GB/s.
        dcn_host_gbps=400.0,
        # The same: 8 H100 GPUs over 4 NVSwitch chips in one host.
        max_devices=8,
    ),
}


def get_generation(name: str) -> Generation:
    try:
        return GENERATIONS[name]
    except KeyError:
        raise ValueError(f"unknown GPU generation {name!r} (known: "
                         f"{sorted(GENERATIONS)})") from None


@dataclass(frozen=True)
class LinkCostModel:
    """Bandwidth figures the prediction consumes, GB/s; defaults from the
    generation's spec, replaced by measured ones after calibration."""

    ici_link_gbps: float
    dcn_host_gbps: float
    hbm_gbps: float = 0.0

    @staticmethod
    def for_generation(gen_name: str, **overrides) -> "LinkCostModel":
        g = get_generation(gen_name)
        return LinkCostModel(
            ici_link_gbps=float(overrides.pop("ici_link_gbps", g.ici_link_gbps)),
            dcn_host_gbps=float(overrides.pop("dcn_host_gbps", g.dcn_host_gbps)),
            hbm_gbps=float(overrides.pop("hbm_gbps", g.hbm_gbps)),
            **overrides,
        )


@dataclass(frozen=True)
class GpuTopology:
    """``n`` GPUs of one generation in one NVSwitch domain."""

    generation: Generation
    n: int

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.n,)

    def describe(self) -> str:
        return f"{self.generation.name}:{self.n}"


_SPEC = re.compile(r"^([a-z][a-z0-9]*):(\d+)$")


def parse_topology(spec: str) -> GpuTopology:
    """``"h100:<n>"``: n GPUs in one NVSwitch domain, 1 <= n <= 8."""
    m = _SPEC.match(spec.strip())
    if not m:
        raise ValueError(f"bad GPU topology spec {spec!r} (want e.g. 'h100:4')")
    gen = get_generation(m.group(1))
    n = int(m.group(2))
    if not 1 <= n <= gen.max_devices:
        raise ValueError(f"{gen.name} topology needs 1..{gen.max_devices} GPUs "
                         f"in one NVSwitch domain, got {n}")
    return GpuTopology(generation=gen, n=n)


def predict_allreduce_gbps(topo: GpuTopology, dims: tuple[int, ...] | None = None,
                           cost: LinkCostModel | None = None) -> float:
    """Predicted ring all-reduce algorithm bandwidth of the ``dims`` members
    (default: the whole topology) through the switch fabric."""
    cost = cost or LinkCostModel.for_generation(topo.generation.name)
    n = 1
    for d in dims or topo.dims:
        n *= d
    return cost.ici_link_gbps * n / (2.0 * (n - 1)) if n > 1 else 0.0
