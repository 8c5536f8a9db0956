"""The port imports without JAX and without the JAX package, and its
device entry points default to CUDA and raise without a card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def _port_modules():
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(SRC).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    for m in ("repro_torch.kernels.lut_pipeline.ops",
              "repro_torch.kernels.pim_mac.ops", "repro_torch.quant.int8",
              "repro_torch.models.lm", "repro_torch.models.hetero_linear",
              "repro_torch.models.moe", "repro_torch.models.recurrent",
              "repro_torch.serve.engine", "repro_torch.launch.serve",
              "repro_torch.fleet.router", "repro_torch.fleet.hierarchy",
              "repro_torch.fleet.dag", "repro_torch.launch.fleet",
              "repro_torch.launch.obs", "repro_torch.tree",
              "repro_torch.data.synthetic", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.optim.compression",
              "repro_torch.train", "repro_torch.train.step",
              "repro_torch.train.trainer", "repro_torch.checkpoint.ckpt",
              "repro_torch.launch.specs", "repro_torch.launch.train"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
            "             and sys.modules[m] is not None)\n"
            "assert not bad, bad\n"
            "print(len(sys.argv), 'ok')\n")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract does "
                    "not apply")


def test_device_entry_points_default_to_cuda_and_raise_without_a_card():
    _require_no_card()
    import numpy as np

    from repro_torch import api
    from repro_torch.core import spaces as sp
    from repro_torch.core.placement import build_lut, build_lut_grid
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.knapsack_dp.ops import knapsack_dp
    from repro_torch.kernels.lut_pipeline.ops import lut_build
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import DecodeEngine
    from repro_torch.serve.hetero import HeteroServeEngine

    sub = api.substrate("edge-hhpim")
    T = sub.default_t_slice_ns()
    em = sub.energy_model()
    calls = [
        lambda: api.lut("edge-hhpim", solver="dp"),
        lambda: api.scheduler("edge-hhpim", solver="dp"),
        lambda: api.compiler(),
        lambda: api.solver("dp").build_lut(em, t_slice_ns=T, n_points=4),
        lambda: build_lut(sp.hh_pim(), sp.EFFICIENTNET_B0, t_slice_ns=T,
                          method="dp", n_points=4),
        lambda: build_lut_grid([em], t_slice_ns=T, n_points=4),
        lambda: lut_build(np.ones((1, 1, 1)), np.ones((1, 1, 1)), 4, 2,
                          np.zeros(1)),
        lambda: knapsack_dp([1], [1.0], 4, 2),
    ]
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    calls += [
        lambda: api.engine("gpu-pool", cfg, params),
        lambda: HeteroServeEngine(cfg, params),
        lambda: DecodeEngine(cfg, params),
        lambda: lm.init_decode_state(cfg, 1, 8),
        lambda: lm.params_from_numpy({}),
        lambda: serve.main(["--engine", "batch"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_device_resolution_names():
    from repro_torch.device import resolve
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve("meta")
