"""The fleet cell's driver at smoke size on the CPU: a run is judged
correct, its control (the reference in fp8) is not, and a run with the
timed path broken underneath is not: a token altered where it is
produced, a decode step that leaves its state unchanged, a migration
that quantizes a column wrongly, a clock that is not energy-minimal, a
LUT entry altered where it is built."""
import pytest
import torch

from portbench.tests import smoke

CELL = "internlm2_1_8b.fleet_mmpp"
# warm-up slices are judged too: a dozen serve over a hundred tokens
# whatever the window holds on a loaded machine
WARM = dict(warm_slices=12)


def test_run_is_correct_and_control_reads_far_above():
    """At smoke size the program (float32 here) reads 0 and every LUT and
    slice choice equals the reference's; the control (the reference in
    fp8) is judged by the same limit and fails it, so the run is not
    correct."""
    r = smoke.run(CELL, seconds=0.3, control=True, **WARM)
    checks = {n: (v, lim) for n, v, lim in r.checks}
    own = {n: vl for n, vl in checks.items() if not n.endswith("_control")}
    assert all(v <= lim for v, lim in own.values()), r.checks
    assert set(own) == set(r.cell.limits)
    assert r.counts["served_checked"] > 0 and r.counts["segments_checked"] > 0
    assert r.counts["engine_slices_checked"] >= 4 * len(r.units)
    assert r.units and r.window_s >= 0.3 and r.setup_s > 0
    gap = own["decode_gap"][0]
    assert r.readings["decode_gap_fp8"] > max(3 * gap, 0.05)
    v, lim = checks["decode_gap.fp8_control"]
    assert v == r.readings["decode_gap_fp8"] and lim == own["decode_gap"][1]
    assert v > lim and not r.correct


def test_clock_not_energy_minimal(monkeypatch):
    """A DVFS controller that always runs the highest clock."""
    from repro_torch.core import techmodel

    def top(self, n_plan, *, slowdown=None):
        c = self.clocks[-1]
        lut = self.lut_for(c, slowdown)
        return (c, self._em_for(c, slowdown), lut,
                lut.lookup(self.t_slice_ns / max(int(n_plan), 1)))
    monkeypatch.setattr(techmodel.DVFSController, "select", top)
    r = smoke.run(CELL, seconds=0.3, **WARM)
    assert not r.correct
    assert dict((n, v) for n, v, _ in r.checks)["slice_choice_mismatch"] > 0


def test_lut_entry_altered_where_produced(monkeypatch):
    from repro_torch.core import placement
    entries = placement._dp_entries

    def nudged(*a, **k):
        out = entries(*a, **k)
        e = out[len(out) // 2]
        e.e_task_pj = e.e_task_pj * (1 + 1e-12)
        return out
    monkeypatch.setattr(placement, "_dp_entries", nudged)
    r = smoke.run(CELL, seconds=0.3, **WARM)
    assert not r.correct
    assert dict((n, v) for n, v, _ in r.checks)["lut_mismatch"] > 0


def test_token_altered_where_produced(monkeypatch):
    from repro_torch.models import lm
    step = lm.decode_step

    def shifted(*a, **k):
        logits, state = step(*a, **k)
        return torch.roll(logits, 1, dims=-1), state
    monkeypatch.setattr(lm, "decode_step", shifted)
    r = smoke.run(CELL, seconds=0.3, **WARM)
    assert not r.correct
    assert dict((n, v) for n, v, _ in r.checks)["decode_gap"] > \
        r.cell.limits["decode_gap"]


def test_step_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.models import attention
    decode = attention.attention_decode

    def stale(p, x, cfg, cache, pos):
        out, _ = decode(p, x, cfg, {k: v.clone() for k, v in cache.items()},
                        pos)
        return out, cache
    monkeypatch.setattr(attention, "attention_decode", stale)
    r = smoke.run(CELL, seconds=0.3, **WARM)
    assert not r.correct


def test_migration_quantizes_wrongly(monkeypatch):
    from repro_torch.models import hetero_linear
    from repro_torch.serve import hetero
    split = hetero_linear.split_weight

    def off_by_one(w, counts, formats=None):
        segs = split(w, counts, formats)
        for s in segs.values():
            if "q" in s:
                s["q"] = s["q"].clone()
                s["q"][0, 0] = s["q"][0, 0] // 2
                break
        return segs
    monkeypatch.setattr(hetero, "split_weight", off_by_one)
    r = smoke.run(CELL, seconds=0.3, **WARM)
    assert not r.correct
    assert dict((n, v) for n, v, _ in r.checks)["segment_mismatch"] > 0


@pytest.mark.gpu
def test_cell_on_the_card_is_correct_and_its_control_is_not():
    """The cell at its own size, a short window: the program within the
    limits, the control (the reference in fp8) beyond them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import bench
    c = bench.Cell(bench.manifest(), CELL)
    r = bench.Run(c, 2 ** 31 + 5, 3.0, False, device="cuda", control=True)
    bench.driver(c.traffic["driver"]).run(r)
    own = [(n, v, lim) for n, v, lim in r.checks
           if not n.endswith("_control")]
    assert all(v <= lim for _, v, lim in own), r.checks
    assert r.readings["decode_gap_fp8"] > c.limits["decode_gap"]
    assert not r.correct


def test_untraced_run_off_the_card_reads_no_device_time():
    """The card's busy time comes from a profile of the card alone: off
    the card an untraced run records none, and its reader gives
    nothing rather than 0."""
    from portbench import bench
    r = smoke.run(CELL, seconds=0.3)
    assert r.correct and r.counts["completed"] > 0
    assert "window_busy_s" not in r.counts
    assert bench.reader("device_ms_per_req")(r) is None
