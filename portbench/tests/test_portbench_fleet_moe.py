"""The MoE fleet cell's driver at smoke size on the CPU: a run is judged
correct, its control (the reference in fp8) is not, and a run with the
timed path broken underneath is not: a held expert dropped from the
routed sum, a gate renormalised over the top-k, an expert matrix
quantized wrongly by the migration. The readers of the cell's new
metrics, on the counts a traced run leaves."""
import copy

import pytest
import torch

from portbench.tests import smoke  # noqa: F401  (puts src on the path)
from portbench import bench

CELL = "deepseek_v2_lite.fleet_moe_mmpp"
# the catalog keys at toy widths: a dense layer and two MoE layers, 4 of
# 16 experts held (the cell's quarter), top-6
SMOKE = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 128, "moe_intermediate_size": 32,
         "n_routed_experts": 16, "n_experts": 4, "vocab_size": 512,
         "num_hidden_layers": 3, "compute_dtype": "float32"}
# the judged steps are those of the mix's first period, whatever the
# machine's pace: 40 slices of warm-up, then a window (shorter than any
# slice) that runs on to the period's end (a faulty gate moves the
# logits more as the histories grow)
WARM = dict(warm_slices=40, max_batch=8, check_final_experts=4)


def _run(seed=7, seconds=0.01, trace=False, control=False, **traffic):
    c = bench.Cell(bench.manifest(), CELL)
    c.config = dict(copy.deepcopy(c.config), **SMOKE)
    c.traffic = dict(copy.deepcopy(c.traffic), **dict(WARM, **traffic))
    r = bench.Run(c, seed, seconds, trace, device="cpu", control=control)
    bench.driver(c.traffic["driver"]).run(r)
    return r


def _checks(r):
    return {n: v for n, v, _ in r.checks}


def test_run_is_correct_and_control_reads_far_above():
    r = _run(control=True)
    checks = {n: (v, lim) for n, v, lim in r.checks}
    own = {n: vl for n, vl in checks.items() if not n.endswith("_control")}
    assert all(v <= lim for v, lim in own.values()), r.checks
    assert set(own) == set(r.cell.limits)
    assert r.counts["served_checked"] > 0
    assert r.counts["segments_checked"] > 4
    assert r.counts["engine_slices_checked"] >= 4 * len(r.units)
    gap = own["decode_gap"][0]
    assert r.readings["decode_gap_fp8"] > max(3 * gap, 0.05)
    assert r.readings["logit_err_fp8"] > r.cell.limits["logit_err"]
    assert r.readings["expert_err_fp8"] > r.cell.limits["expert_err"]
    assert r.counts["expert_layers_checked"] > 10
    v, lim = checks["decode_gap.fp8_control"]
    assert v > lim and not r.correct


def test_rows_start_from_seeded_tokens():
    """Each engine's rows start from tokens drawn from the seed, so the
    rows decode apart (with token 0 everywhere they would all agree)."""
    from repro_torch.serve import hetero
    seen = []
    start = hetero.HeteroServeEngine.start_tokens

    def spy(self, tokens):
        seen.append(torch.as_tensor(tokens).clone())
        return start(self, tokens)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hetero.HeteroServeEngine, "start_tokens", spy)
        r = _run()
    assert r.correct
    assert len(seen) == 4 and all(len(set(t.tolist())) > 1 for t in seen)


def test_held_expert_dropped(monkeypatch):
    """The routed sum leaves out held expert 0's part."""
    from repro_torch.models import moe
    route = moe.route

    def drop(router, x, cfg):
        w, e = route(router, x, cfg)
        return torch.where(e == 0, 0.0, w), e
    monkeypatch.setattr(moe, "route", drop)
    r = _run()
    assert not r.correct
    assert _checks(r)["logit_err"] > r.cell.limits["logit_err"]
    assert _checks(r)["expert_err"] > r.cell.limits["expert_err"]


def test_gate_renormalised(monkeypatch):
    """The top-k gate weights renormalised to sum to 1."""
    from repro_torch.models import moe
    route = moe.route

    def renorm(router, x, cfg):
        w, e = route(router, x, cfg)
        return w / w.sum(-1, keepdim=True), e
    monkeypatch.setattr(moe, "route", renorm)
    r = _run()
    assert not r.correct
    assert _checks(r)["logit_err"] > r.cell.limits["logit_err"]
    assert _checks(r)["expert_err"] > r.cell.limits["expert_err"]


def test_expert_matrix_quantized_wrongly(monkeypatch):
    """Every expert matrix's first int8 tier off in one element."""
    from repro_torch.models import hetero_linear
    from repro_torch.serve import hetero
    split = hetero_linear.split_weight

    def off_by_one(w, counts, formats=None):
        segs = split(w, counts, formats)
        if w.shape[1] == SMOKE["moe_intermediate_size"]:
            for s in segs.values():
                if "q" in s:
                    s["q"] = s["q"].clone()
                    s["q"][0, 0] = s["q"][0, 0] // 2 + 1
                    break
        return segs
    monkeypatch.setattr(hetero, "split_weight", off_by_one)
    r = _run()
    assert not r.correct
    assert _checks(r)["segment_mismatch"] > 0


def test_readers_of_the_traced_counts():
    """Per decode step, the card time of each span; the step's useful
    FLOPs over the stretch at the bf16 peak, on the rows decoded for
    requests: each row through the weights every row uses and its
    token-choices through the held experts, counted on the card
    (``fleet_moe.decode_mfu``) or at the routed share's expected size
    (``fleet.decode_mfu``, as on the dense cells); nothing where a count
    is missing, as on a program without the spans."""
    from portbench.counts import BF16_FLOPS
    r = bench.Run(bench.Cell(bench.manifest(), CELL), 1, 1.0, True,
                  device="cpu")
    for name in ("fleet_moe.expert_ms", "fleet_moe.mla_ms",
                 "fleet_moe.decode_mfu", "fleet.decode_mfu"):
        assert bench.reader(name)(r) is None
    r.device_trace = {"window_s": 2.0, "busy_s": 1.0}
    r.counts.update(traced_decodes=40, traced_batch_rows=40 * 64,
                    traced_rows=600, expert_busy_s=0.2, mla_busy_s=0.05,
                    row_params=10, expert_params=3, matmul_params=14,
                    traced_expert_tokens=1280)
    assert bench.reader("fleet_moe.expert_ms")(r) == 0.2 / 40 * 1e3
    assert bench.reader("fleet_moe.mla_ms")(r) == 0.05 / 40 * 1e3
    assert bench.reader("fleet_moe.decode_mfu")(r) == pytest.approx(
        100.0 * 2.0 * 600 * (10 + 0.5 * 3) / 2.0 / BF16_FLOPS)
    assert bench.reader("fleet.decode_mfu")(r) == pytest.approx(
        100.0 * 2.0 * 600 * 14 / 2.0 / BF16_FLOPS)


def test_matmul_params_take_the_routed_share_of_the_held_experts():
    """A row's weights on this card: the shared ones and, per MoE layer,
    experts per token x held / routed of the held experts (6 x 16 / 64 =
    1.5 experts a layer at the cell's share)."""
    from portbench import weights_moe
    c = bench.Cell(bench.manifest(), CELL).config
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    assert weights_moe.matmul_params(c) == (
        weights_moe.row_params(c)
        + n_moe * 3 * weights_moe.expert_params(c) // 2)


@pytest.mark.gpu
def test_cell_on_the_card_is_correct_and_its_control_is_not():
    """The cell at its own size, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = bench.Cell(bench.manifest(), CELL)
    r = bench.Run(c, 2 ** 31 + 7, 3.0, False, device="cuda", control=True)
    bench.driver(c.traffic["driver"]).run(r)
    own = [(n, v, lim) for n, v, lim in r.checks
           if not n.endswith("_control")]
    assert all(v <= lim for _, v, lim in own), r.checks
    assert r.readings["decode_gap_fp8"] > c.limits["decode_gap"]
    assert r.readings["logit_err_fp8"] > c.limits["logit_err"]
    assert r.readings["expert_err_fp8"] > c.limits["expert_err"]
    print(f"the cell on the card: {r.checks}")
    assert not r.correct


@pytest.mark.gpu
def test_cell_on_the_card_reads_a_dropped_held_expert(monkeypatch):
    """The cell at its own size with held expert 0's part left out of
    every routed sum: ``expert_err`` reads it above its limit (the
    logits' gap alone read 0.27-0.42 against a correct run's 0.12-0.22)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import moe
    route = moe.route

    def drop(router, x, cfg):
        w, e = route(router, x, cfg)
        return torch.where(e == 0, 0.0, w), e
    monkeypatch.setattr(moe, "route", drop)
    c = bench.Cell(bench.manifest(), CELL)
    r = bench.Run(c, 2 ** 31 + 11, 3.0, False, device="cuda")
    bench.driver(c.traffic["driver"]).run(r)
    checks = _checks(r)
    print(f"dropped held expert at the cell's size: {r.checks}")
    assert checks["expert_err"] > c.limits["expert_err"]
    assert not r.correct
