"""The port's roofline (``launch/roofline.py``) against the JAX
package's, on the CPU.

* ``param_count``, ``train_cost``, ``prefill_cost`` and ``decode_cost``
  equal the reference's exactly for every architecture and shape (the
  analytic counter is carried over unchanged; only the hardware
  constants are the H100's).
* ``param_count`` is within 2 % of the port's ``abstract_params``.
* Decode at 32k is memory-bound under the H100 constants.
* ``roofline_row`` reads a dry-run record of the port's.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.launch import roofline as jax_rl  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_costs_equal_the_references(arch):
    jcfg = jax_specs.dryrun_config(jax_config(arch))
    tcfg = specs.dryrun_config(get_config(arch))
    assert rl.param_count(tcfg) == jax_rl.param_count(jcfg)
    assert rl.active_params(tcfg) == jax_rl.active_params(jcfg)
    for shape, (S, B, _kind) in specs.SHAPES.items():
        for n_micro in (1, 8, 16):
            assert rl.train_cost(tcfg, S, B, n_micro) \
                .__dict__ == jax_rl.train_cost(jcfg, S, B, n_micro).__dict__
        assert rl.prefill_cost(tcfg, S, B).__dict__ \
            == jax_rl.prefill_cost(jcfg, S, B).__dict__
        assert rl.decode_cost(tcfg, S, B).__dict__ \
            == jax_rl.decode_cost(jcfg, S, B).__dict__
        assert rl.cell_cost(tcfg, shape).__dict__ \
            == jax_rl.cell_cost(jcfg, shape).__dict__


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_param_count_matches_abstract_params(arch):
    cfg = dataclasses.replace(get_config(arch), scan_layers=False)
    real = sum(x.numel() for x in leaves(specs.abstract_params(
        cfg, device="cpu")))
    # the analytic count leaves out norm scales and gate biases (tiny)
    assert rl.param_count(cfg)["total"] == pytest.approx(real, rel=0.02)


def test_decode_is_memory_bound_on_the_h100():
    cfg = ModelConfig(name="v", family="dense", n_layers=2, d_model=128,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=1024,
                      head_dim=32, dtype=torch.float32, scan_layers=False,
                      remat=False)
    cost = rl.decode_cost(cfg, S=32768, B=128)
    assert cost.flops > 0 and cost.hbm_bytes > 0
    assert (cost.hbm_bytes / rl.HBM_BW) > (cost.flops / rl.PEAK_FLOPS)
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12,
                                                      50e9)


def test_roofline_row_reads_a_dry_run_record(tmp_path):
    rec = {"microbatches": 8, "collectives": {"total": 5e9},
           "memory": {"argument_size_in_bytes": 2 ** 30,
                      "temp_size_in_bytes": 2 ** 30}}
    (tmp_path / "internlm2_1_8b__train_4k__single.json").write_text(
        json.dumps(rec))
    row = rl.roofline_row("internlm2_1_8b", "train_4k", "single", tmp_path)
    cost = rl.cell_cost(specs.dryrun_config(get_config("internlm2_1_8b")),
                        "train_4k", n_micro=8)
    assert row["compute_s"] == cost.flops / (256 * rl.PEAK_FLOPS)
    assert row["collective_s"] == 5e9 / rl.LINK_BW
    assert row["mem_gib_per_dev"] == 2.0
    assert row["dominant"] in ("compute", "memory", "collective")
    skipped = rl.roofline_row("internlm2_1_8b", "long_500k", "single",
                              tmp_path)
    assert skipped["status"] == "skipped"
