"""The port's dry run (``launch/dryrun.py``) on the recurrent families, on
a fake world in a subprocess (its own, so that tests/test_torch_
dryrun.py's fixture keeps its time).

Reduced recurrentgemma_2b and xlstm_1_3b train and prefill cells
(``specs.dryrun_config`` on a fake (data, model) = (2, 4) mesh) each
trace with status ``ok``: their scans run as one op per block
(``repro_torch::{rglru,mlstm,slstm}_scan``, with each scan's backward
op in training) through DTensor's sharding rules. Per-device
argument bytes are the sum of the rules' local shard shapes, and the
FLOPs include the ops' registered counts: the cell traced without them
counts exactly the scans' share less (per block 12 B S d for RG-LRU and
sLSTM, 5 B S H hd^2 for mLSTM; training adds the remat recompute and the
backward's two forwards, 4x in all, as ``roofline.py`` counts it).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_RUN = """
import json, math, warnings
import torch
from torch.utils.flop_counter import flop_registry
warnings.filterwarnings("ignore")
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, specs as sp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.common import reduced
from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import flatten_with_path

SCANS = [getattr(torch.ops.repro_torch, n) for n in
         ("rglru_scan", "rglru_scan_bwd", "mlstm_scan", "slstm_scan",
          "mlstm_scan_bwd", "slstm_scan_bwd")]


def rules_bytes(cfg, seq, batch, kind, rec, mesh):
    with torch._subclasses.fake_tensor.FakeTensorMode():
        b = sp.train_batch_specs(cfg, seq, batch, device="cpu")
        trees = [(b, sh.batch_shardings(b, mesh))]
        if kind == "train":
            pb = sp.abstract_params(cfg, torch.bfloat16, device="cpu")
            ps = sh.params_shardings(pb, mesh, inference=rec["zero1"])
            o = make_optimizer(OptimizerConfig(kind=rec["optimizer"])
                               ).init(pb)
            trees += [(pb, ps), (o, sh.params_shardings_like(o, pb, ps,
                                                             mesh))]
        else:
            p = sp.abstract_params(cfg, torch.bfloat16, device="cpu")
            trees.append((p, sh.params_shardings(
                p, mesh, inference=rec["tp_only_params"])))
    total = 0
    for tree, specs in trees:
        for path, leaf in flatten_with_path(tree):
            spec = specs
            for k in path:
                spec = spec[k]
            total += math.prod(sh.local_shape(
                tuple(leaf.shape), spec, mesh)) * leaf.element_size()
    return total


def scan_flops(cfg, seq, batch, kind):
    per = 0
    for k in cfg.pattern_for_depth():
        if k == "mlstm":
            per += 5 * batch * seq * cfg.n_heads * cfg.hd ** 2
        elif k in ("rglru", "slstm"):
            per += 12 * batch * seq * cfg.d_model
    return per * (4 if kind == "train" else 1)


out = {}
dryrun.start_fake_world(8)
mesh = make_test_mesh(data=2, model=4, device="cpu")
for arch, kind in (("recurrentgemma_2b", "train"),
                   ("recurrentgemma_2b", "prefill"),
                   ("xlstm_1_3b", "train"),
                   ("xlstm_1_3b", "prefill")):
    cfg = sp.dryrun_config(reduced(get_config(arch)), mesh)
    seq, batch = 64, 16
    rec = dryrun.trace_cell(cfg, seq, batch, kind, mesh, "cpu")
    saved = {op: flop_registry.pop(op) for op in SCANS}
    try:
        bare = dryrun.trace_cell(cfg, seq, batch, kind, mesh, "cpu")
    finally:
        flop_registry.update(saved)
    out[f"{arch}:{kind}"] = {
        "rec": rec, "bare_flops": bare["cost"]["flops"],
        "scan_flops": scan_flops(cfg, seq, batch, kind),
        "expected_argument_bytes": rules_bytes(cfg, seq, batch, kind, rec,
                                               mesh)}
print(json.dumps(out))
"""

CELLS = ["recurrentgemma_2b:train", "recurrentgemma_2b:prefill",
         "xlstm_1_3b:train", "xlstm_1_3b:prefill"]


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_RUN)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_cells_trace_on_a_fake_mesh(traced, cell):
    c = traced[cell]
    rec = c["rec"]
    assert rec["mesh"] == {"data": 2, "model": 4}
    assert rec["memory"]["argument_size_in_bytes"] \
        == c["expected_argument_bytes"]
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    if rec["kind"] == "train":
        assert rec["microbatches"] == 8 and rec["optimizer"] == "adamw_mp"


@pytest.mark.parametrize("cell", CELLS)
def test_recurrent_cells_count_the_scans_registered_flops(traced, cell):
    c = traced[cell]
    assert c["scan_flops"] > 0
    assert c["rec"]["cost"]["flops"] - c["bare_flops"] == c["scan_flops"]
