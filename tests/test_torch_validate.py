"""The port's H100 link model (tputopo_torch.linkmodel) and its
predicted-vs-measured validation and calibration (tputopo_torch.validate),
held to the reference's ring rule, errors and record keys."""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.torch_parity import world_of_one
from tputopo.topology.model import parse_topology as jparse
from tputopo.workloads import validate as jv
from tputopo_torch import linkmodel as lm
from tputopo_torch import validate as tv

torch.set_num_threads(1)

H100 = lm.get_generation("h100")


def test_h100_spec_figures():
    assert H100.ici_link_gbps == 450.0  # 900 GB/s NVLink, both directions
    assert H100.hbm_gbps == 3350.0
    assert H100.dcn_host_gbps == 400.0
    cost = lm.LinkCostModel.for_generation("h100")
    assert (cost.ici_link_gbps, cost.hbm_gbps, cost.dcn_host_gbps) == (450.0, 3350.0, 400.0)
    assert lm.LinkCostModel.for_generation("h100", hbm_gbps=1.0).hbm_gbps == 1.0


@pytest.mark.parametrize("n", range(1, 9))
def test_prediction_is_the_ring_rule_through_the_switch(n):
    topo = lm.parse_topology(f"h100:{n}")
    assert topo.dims == (n,) and topo.describe() == f"h100:{n}"
    want = 0.0 if n == 1 else 450.0 * n / (2 * (n - 1))
    assert lm.predict_allreduce_gbps(topo) == pytest.approx(want)
    assert lm.predict_allreduce_gbps(topo, topo.dims) == pytest.approx(want)


@pytest.mark.parametrize("n", range(1, 9))
def test_prediction_uses_the_scorers_ring_factor(n):
    """The scorer's per-axis ring factor d / (2 (d - 1)), 0 for d = 1
    (tputopo/topology/score.py), times one card's link bandwidth."""
    from tputopo.topology.score import _ring_factor

    topo = lm.parse_topology(f"h100:{n}")
    assert lm.predict_allreduce_gbps(topo) == pytest.approx(450.0 * _ring_factor(n))


@pytest.mark.parametrize("spec", ["h100:0", "h100:9", "h100", "a100:4", "h100:2x2",
                                  "v5e:4x4"])
def test_bad_topology_specs_are_refused(spec):
    with pytest.raises(ValueError):
        lm.parse_topology(spec)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_calibration_roundtrips(n):
    """Predicting with the calibrated model returns the measurement."""
    topo = lm.parse_topology(f"h100:{n}")
    cal = tv.calibrate_cost_model(topo, 123.4)
    assert lm.predict_allreduce_gbps(topo, topo.dims, cal) == pytest.approx(123.4)
    both = tv.calibrate_cost_model(topo, 88.8, measured_hbm_gbps=2900.0)
    assert lm.predict_allreduce_gbps(topo, topo.dims, both) == pytest.approx(88.8)
    assert both.hbm_gbps == 2900.0


def test_calibration_errors_are_the_reference_ones():
    single = lm.parse_topology("h100:1")
    with pytest.raises(ValueError, match="no multi-chip axis"):
        tv.calibrate_cost_model(single, 10.0)
    hbm_only = tv.calibrate_cost_model(single, measured_hbm_gbps=2900.0)
    assert hbm_only.hbm_gbps == 2900.0
    assert hbm_only.ici_link_gbps == H100.ici_link_gbps
    topo = lm.parse_topology("h100:4")
    for fn, args, kw, msg in [
            (tv.calibrate_cost_model, (topo,), {}, "nothing to calibrate"),
            (tv.calibrate_cost_model, (topo,), {"measured_hbm_gbps": -1.0},
             "measured_hbm_gbps"),
            (tv.calibrate_cost_model, (topo, 0.0), {}, "measured_algbw_gbps")]:
        with pytest.raises(ValueError, match=msg):
            fn(*args, **kw)
    jtopo = jparse("v5e:4x4:wrap=00")
    for kw in ({}, {"measured_hbm_gbps": -1.0}):
        with pytest.raises(ValueError, match="nothing to calibrate|measured_hbm_gbps"):
            jv.calibrate_cost_model(jtopo, **kw)


def test_measured_vs_spec_has_the_reference_keys():
    topo = lm.parse_topology("h100:8")
    cal = tv.calibrate_cost_model(topo, 300.0, measured_hbm_gbps=2900.0)
    rec = tv.measured_vs_spec(cal, "h100")
    jtopo = jparse("v5e:4x4:wrap=00")
    ref = jv.measured_vs_spec(jv.calibrate_cost_model(jtopo, 88.8, measured_hbm_gbps=578.0),
                              "v5e")
    assert set(rec) == set(ref)
    assert all(set(rec[k]) == set(ref[k]) for k in rec)
    assert rec["hbm_gbps"] == {"spec": 3350.0, "calibrated": 2900.0,
                               "calibrated_over_spec": round(2900.0 / 3350.0, 3)}
    assert rec["ici_link_gbps"]["calibrated"] == round(300.0 * 2 * 7 / 8, 1)


def test_validate_slice_reports_with_the_reference_keys():
    with world_of_one():
        report = tv.validate_slice("h100:1", payload_mb=0.25, iters=2)
    d = report.to_dict()
    ref_keys = {"topology", "predicted_gbps", "measured_gbps", "efficiency",
                "measured_n_devices", "measured_payload_mb", "measured_time_ms",
                "measured_algbw_gbps", "measured_busbw_gbps"}
    assert set(d) == ref_keys
    assert d["topology"] == "h100:1" and d["predicted_gbps"] == 0.0
    assert d["efficiency"] == 0.0  # nothing predicted for one GPU
    assert d["measured_gbps"] > 0 and d["measured_n_devices"] == 1
    assert report.measured_gbps == report.measured.algbw_gbps
