"""The frozen references held to ``repro_torch`` at smoke sizes on the
CPU, so that a drift of either side shows: dense logits through the
engines' ring, the serve engine's weight tiers (bitwise), a DVFS
scheduler's grid of LUTs (bitwise) and its choice in every slice."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.tests import smoke
from portbench import weights
from portbench.drivers import lut_entries, program_config
from portbench.reference import common, dense, quant
from portbench.reference import placement as ref

# float32 sums taken in another order over a few layers (logits O(1))
LOGIT_ATOL = 1e-4


def _config(name):
    return smoke.cell(name).config


@pytest.fixture(autouse=True)
def _exact():
    common.exact()


def test_dense_logits_equal_the_engines_decode_through_the_ring():
    from repro_torch.models import lm
    c = _config("internlm2_1_8b.fleet_mmpp")
    params = weights.make(c, 2 ** 31 + 3, "cpu")
    cfg = program_config(c)
    ring, L = 8, 21                       # the ring wraps twice
    toks = torch.randint(0, c["vocab_size"], (2, L),
                         generator=torch.Generator().manual_seed(1))
    st = lm.init_decode_state(cfg, 2, ring, device="cpu")
    prog = []
    for t in range(L):
        lg, st = lm.decode_step(params, cfg, st, toks[:, t], t)
        prog.append(lg)
    ref = dense.logits(params, c, toks, ring)
    assert torch.allclose(torch.stack(prog, 1), ref, atol=LOGIT_ATOL, rtol=0)


def test_weight_tiers_bitwise():
    from repro_torch.models.hetero_linear import (fractions_to_counts,
                                                  split_weight)
    c = _config("internlm2_1_8b.fleet_mmpp")
    plan = [tuple(x) for x in smoke.cell(
        "internlm2_1_8b.fleet_mmpp").traffic["tier_plan"]]
    w = weights.make(c, 5, "cpu")["stack"]["tail_0"]["ffn"]["w_up"]
    K = quant.model_spec_params(c)
    order = tuple(t for _, t, _ in plan)
    formats = {t: f for _, t, f in plan}
    for placement in ({"hp_sram": K // 3, "hp_mram": K // 4,
                       "lp_sram": K // 5, "lp_mram": K - K // 3 - K // 4
                       - K // 5},
                      {"lp_mram": K}, {"hp_sram": K // 2, "lp_mram": K // 2}):
        counts = fractions_to_counts(
            w.shape[-1], {dict((s, t) for s, t, _ in plan)[k]: v
                          for k, v in placement.items()}, K, order=order)
        assert counts == quant.counts(w.shape[1], placement, K, plan)
        segs = split_weight(w.float(), {t: counts.get(t, 0) for t in order},
                            formats=formats)
        segs = {t: {k: v for k, v in s.items() if k != "empty"}
                for t, s in segs.items()}
        assert quant.mismatches(w, placement, K, plan, segs) == 0
        tier = next(t for t, s in segs.items() if "q" in s)
        segs[tier]["q"] = segs[tier]["q"].clone()
        segs[tier]["q"][0, 0] += 1
        assert quant.mismatches(w, placement, K, plan, segs) == 1


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = common.to_fp8(x)
    assert 0 < float((y - x).detach().abs().max()) <= 3 / 8
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert dataclasses.is_dataclass(program_config(_config(
        "internlm2_1_8b.fleet_mmpp")))


def _fleet_scheduler(index: int):
    """Engine ``index`` of the fleet cell's mixed pool, a DVFS scheduler
    built alone at smoke size, with the reference's view of it: the
    substrate's parameters, the fleet's slice, the grid of LUTs."""
    from repro_torch import api
    cell = smoke.cell("internlm2_1_8b.fleet_mmpp")
    c, tr = cell.config, cell.traffic
    sub = tr["substrate_params"]
    sw = ref.shape(sub, index, tr["mixed"])
    t_slice = min(ref.default_t_slice_ns(c, ref.shape(sub, i, tr["mixed"]))
                  for i in range(tr["n_engines"]))
    sched = api.scheduler("gpu-pool", program_config(c), solver="dp",
                          dvfs=True, t_slice_ns=t_slice, device="cpu",
                          n_hp_clusters=sw["n_hp_clusters"],
                          n_lp_clusters=sw["n_lp_clusters"],
                          tokens_per_task=sw["tokens_per_task"])
    return sched, t_slice, ref.grid(c, sw, t_slice)


@pytest.mark.parametrize("index", [0, 1])
def test_dvfs_grid_luts_bitwise(index):
    """Every LUT of a full and of a half engine's clock grid."""
    sched, _, points = _fleet_scheduler(index)
    assert list(sched.dvfs.clocks) == [p[0] for p in points]
    for clock, _, want in points:
        assert lut_entries(sched.dvfs.lut_for(clock)) == want


@pytest.mark.parametrize("seed", range(6))
def test_slice_choices_equal_the_dvfs_schedulers(seed):
    """Forty slices of random backlogs and plans, past the peak too: the
    clock, placement and tasks run of every slice."""
    sched, t_slice, points = _fleet_scheduler(seed % 2)
    rng = np.random.default_rng(seed)
    prev = dict(sched.placement)
    clocks, moved = set(), 0
    for _ in range(40):
        n = int(rng.integers(0, 14))
        planned = max(n, int(rng.integers(0, 14)))
        rep = sched.step(n, lookup_tasks=planned, cap_to_capacity=True)
        want = ref.choose(points, t_slice, n, planned, prev)
        assert (rep.clock, dict(rep.placement), rep.n_executed) == want
        prev = want[1]
        clocks.add(rep.clock)
        moved += rep.moved_weights > 0
    assert len(clocks) >= 2 and moved >= 2
