"""The whole slice: the port's per-slice runtime against the JAX
package's, exactly.

``repro_torch.api.scheduler(..., device="cpu")`` must produce the same
``SliceReport`` sequence as ``repro.api.scheduler(...)`` on the paper's
six load scenarios: closed-form on all 11 registered substrates (and
the fixed Table I policies on their edge archs), and the dp solver on
edge-hhpim, cxl-tier-3 and gpu-pool, with and without the online DVFS
controller. The host math is the same numpy, so every float must be
equal - no tolerance.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro.core import system as jax_system  # noqa: E402
from repro.core import workloads  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import system  # noqa: E402

SUBSTRATES = sorted(jax_api.list_substrates())


def _reports(api_mod, name, *, compiler, **kw):
    out = []
    for scen, loads in workloads.SCENARIOS.items():
        sched = api_mod.scheduler(name, compiler=compiler, **kw)
        out.append((scen, [dataclasses.asdict(r) for r in sched.run(loads)]))
    return out


def _assert_same_runs(name, **kw):
    ours = _reports(api, name, compiler=api.compiler(device="cpu"),
                    device="cpu", **kw)
    ref = _reports(jax_api, name, compiler=jax_api.compiler(), **kw)
    assert len(ours) == len(workloads.SCENARIOS)
    for (scen, a), (_, b) in zip(ours, ref):
        assert a == b, (name, scen)
    return ours


def test_registries_match():
    assert api.list_substrates() == jax_api.list_substrates()
    assert len(SUBSTRATES) == 11
    assert sorted(api.SOLVERS) == sorted(jax_api.SOLVERS)


@pytest.mark.parametrize("name", SUBSTRATES)
def test_closed_form_slice_reports_match(name):
    _assert_same_runs(name, solver="closed-form")


@pytest.mark.parametrize("name", ["edge-hetero", "edge-hybrid",
                                  "edge-baseline"])
def test_fixed_policy_slice_reports_match(name):
    _assert_same_runs(name)


@pytest.mark.parametrize("name,dvfs", [
    ("edge-hhpim", None),
    ("cxl-tier-3", None), ("cxl-tier-3", True),
    ("gpu-pool", None), ("gpu-pool", True),
])
def test_dp_slice_reports_match(name, dvfs):
    runs = _assert_same_runs(name, solver="dp", dvfs=dvfs)
    clocks = {r["clock"] for _, reps in runs for r in reps}
    assert (None in clocks) == (dvfs is None)


def test_stage_cost_matches():
    sched = api.scheduler("cxl-tier-3", device="cpu")
    ref = jax_api.scheduler("cxl-tier-3")
    for n in (1, 4, 10):
        assert sched.stage_cost(n) == ref.stage_cost(n)


def test_energy_savings_table_matches():
    from repro.core import spaces as jax_sp
    from repro_torch.core import spaces as sp
    ours = system.energy_savings_table(sp.EFFICIENTNET_B0, rho=4.0,
                                       lut_points=16, device="cpu")
    ref = jax_system.energy_savings_table(jax_sp.EFFICIENTNET_B0, rho=4.0,
                                          lut_points=16)
    assert ours == ref


def test_substrate_smoke_runs_every_registry_entry_on_cpu(capsys):
    from repro_torch.launch import substrate_smoke
    substrate_smoke.main(["--device", "cpu", "--lut-points", "4"])
    assert "11/11 substrates ok" in capsys.readouterr().out
