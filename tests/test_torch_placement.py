"""Whole LUT builds of the port against the JAX package's, on the CPU.

  * the 18 golden LUT digests of tests/test_multipool.py, every
    registered substrate x {closed_form, dp}, built with device="cpu";
  * the fused dp build equals the per-point ``batched=False`` anchor,
    and ``build_lut_grid`` equals per-variant builds;
  * ``PlacementCompiler.save/load`` round-trips both ways between
    ``repro`` and ``repro_torch``, with byte-identical JSON files.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.placement import build_lut, build_lut_grid  # noqa: E402
from test_multipool import GOLDEN_LUT_DIGESTS, lut_digest  # noqa: E402


def _entries(lut):
    return [dataclasses.asdict(e) for e in lut.entries]


@pytest.mark.parametrize("key", sorted(GOLDEN_LUT_DIGESTS))
def test_golden_lut_digests_on_cpu(key):
    name, method = key.split(":")
    sub = api.substrate(name)
    model = sub.model_spec()
    lut = build_lut(sub.arch, model, t_slice_ns=sub.default_t_slice_ns(model),
                    n_points=6, k_groups=64, em=sub.energy_model(model),
                    method=method, static_window=sub.static_window,
                    device="cpu")
    assert lut_digest(lut) == GOLDEN_LUT_DIGESTS[key], key
    assert lut.backend == ("cpu" if method == "dp" else None)


@pytest.mark.parametrize("name,n_points,k_groups,dp_ticks", [
    ("edge-hhpim", 5, 24, 192),
    ("cxl-tier-3", 4, 16, 128),      # the C>2 fold with its backtrace
])
def test_fused_dp_matches_per_point_anchor(name, n_points, k_groups,
                                           dp_ticks):
    sub = api.substrate(name)
    em = sub.energy_model()
    kw = dict(t_slice_ns=sub.default_t_slice_ns(), n_points=n_points,
              method="dp", k_groups=k_groups, dp_ticks=dp_ticks, em=em,
              static_window=sub.static_window, device="cpu")
    fused = build_lut(sub.arch, em.model, **kw)
    loop = build_lut(sub.arch, em.model, batched=False, **kw)
    assert fused.entries == loop.entries
    assert any(e.feasible for e in fused.entries)
    assert fused.backend == "cpu" and loop.backend is None
    # and both equal the JAX package's build
    from repro.core.placement import build_lut as jax_build_lut
    jsub = jax_api.substrate(name)
    jem = jsub.energy_model()
    jkw = {k: v for k, v in kw.items() if k not in ("em", "device")}
    ref = jax_build_lut(jsub.arch, jem.model, em=jem, **jkw)
    assert _entries(fused) == _entries(ref)


@pytest.mark.parametrize("name", ["cxl-tier-3", "gpu-pool"])
def test_clock_grid_build_matches_per_variant_builds(name):
    sub = api.substrate(name)
    T = sub.default_t_slice_ns()
    clocks = sub.tech_model().clock_grid(3)
    ems = [sub.with_clock(c).energy_model() for c in clocks]
    kw = dict(t_slice_ns=T, n_points=4, k_groups=16, dp_ticks=128,
              method="dp", static_window=sub.static_window, device="cpu")
    grid = build_lut_grid(ems, **kw)
    assert len(grid) == len(clocks)
    for em, lut in zip(ems, grid):
        single = build_lut(em.arch, em.model, em=em, **kw)
        assert lut.entries == single.entries
        assert lut.backend == single.backend == "cpu"


def test_compiler_clock_grid_one_pass_on_cpu():
    pc = api.compiler(device="cpu")
    sub = api.substrate("cxl-tier-3", solver="dp", lut_points=4)
    luts = pc.compile_clock_grid(sub, n_clocks=3, n_points=4)
    n = len(luts)
    assert n >= 3
    assert pc.stats()["builds"] == n
    assert pc.stats()["builds_by_backend"] == {"cpu": n}
    jpc = jax_api.compiler()
    jluts = jpc.compile_clock_grid(jax_api.substrate(
        "cxl-tier-3", solver="dp", lut_points=4), n_clocks=3, n_points=4)
    assert list(luts) == list(jluts)
    for c in luts:
        assert _entries(luts[c]) == _entries(jluts[c])
    again = pc.compile_clock_grid(sub, n_clocks=3, n_points=4)
    assert pc.stats()["builds"] == n and pc.stats()["hits"] == n
    assert all(again[c] is luts[c] for c in luts)


def _compile(api_mod, compiler):
    sub = api_mod.substrate("cxl-tier-3", tokens_per_task=2)
    variants = [sub.engine_variant(i) for i in range(2)]
    model = sub.model_spec()
    return compiler.compile(variants, model,
                            t_slice_ns=sub.default_t_slice_ns(model),
                            n_points=6)


def test_compiler_cache_round_trips_both_ways(tmp_path):
    """The cache file is the state users carry between processes: one
    saved by either package loads in the other and compares equal, and
    both write the same bytes."""
    jpc = jax_api.compiler()
    jluts = _compile(jax_api, jpc)
    jpc.save(tmp_path / "jax.json")
    pc = api.compiler(device="cpu")
    luts = _compile(api, pc)
    pc.save(tmp_path / "torch.json")
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "torch.json").read_bytes()

    # repro -> repro_torch
    warm = api.compiler(device="cpu")
    assert warm.load(tmp_path / "jax.json") == 1
    again = _compile(api, warm)
    assert warm.stats()["builds"] == 0
    for key, lut in luts.items():
        assert again[key].entries == lut.entries
    # repro_torch -> repro
    jwarm = jax_api.compiler()
    assert jwarm.load(tmp_path / "torch.json") == 1
    jagain = _compile(jax_api, jwarm)
    assert jwarm.stats()["builds"] == 0
    for key, lut in jluts.items():
        assert _entries(jagain[key]) == _entries(luts[key])
    assert api.compiler(device="cpu").load(tmp_path / "nope.json") == 0


def test_grid_build_spans_split_kernel_copy_and_finalize():
    """With tracing on, one build_lut_grid group records the three spans
    the chip smoke reads to split a build's time."""
    from repro_torch import obs
    sub = api.substrate("cxl-tier-3")
    ems = [sub.with_clock(c).energy_model()
           for c in sub.tech_model().clock_grid(2)]
    obs.reset()
    obs.enable()
    try:
        build_lut_grid(ems, t_slice_ns=sub.default_t_slice_ns(), n_points=4,
                       k_groups=16, dp_ticks=128,
                       static_window=sub.static_window, device="cpu")
        names = [ev["name"] for ev in obs.tracer().events()]
    finally:
        obs.reset()
    assert [n for n in names if n.startswith("placement.lut_grid.")] == [
        "placement.lut_grid.kernel", "placement.lut_grid.d2h",
        "placement.lut_grid.finalize"]
