"""The traffic generator: the same seed gives the same traffic, every
seed the same arrivals, and the MMPP agrees with the
program's own generator."""
import numpy as np

from portbench.tests import smoke  # noqa: F401
from portbench import bench, generate


def _mix(name):
    return bench.load_json(bench.PKG / "traffic" / f"{name}.json")


def test_arrivals_deterministic_per_seed():
    """Every seed gets the same arrivals: the fixed period, repeated."""
    p = _mix("fleet_mmpp")["arrivals"]
    a = generate.arrivals(p, 500)
    assert a == generate.arrivals(p, 500)
    n = p["period_slices"]
    assert a[:n] == a[n:2 * n] and len(set(a[:n])) > 3


def test_every_seed_offers_the_same_bursts():
    """Bursts of the high state in the period, at the model's mean."""
    p = _mix("fleet_mmpp")["arrivals"]
    a = generate.arrivals(p, p["period_slices"])
    assert max(a) >= p["rate_high"] and min(a) <= p["rate_low"]
    assert 4.0 < np.mean(a) < 7.0


def test_mmpp_period_is_the_program_model():
    from repro_torch.fleet.traces import mmpp_trace
    p = dict(_mix("fleet_mmpp")["arrivals"])
    ref = mmpp_trace(p["period_slices"], rate_low=p["rate_low"],
                     rate_high=p["rate_high"], p_up=p["p_up"],
                     p_down=p["p_down"], seed=p["base_seed"]).arrivals
    assert generate._mmpp_period(p) == ref
