"""The port's dry run (``launch/dryrun.py``) and its collectives counter
(``launch/collectives.py``), on a fake world in a subprocess.

* One fake ``all_reduce`` of f32[128, 4] counts 2,048 bytes.
* A reduced dense and a reduced MoE config (``specs.dryrun_config`` on a
  fake (data, model) = (2, 4) mesh): a train cell and a prefill cell each
  trace with status ``ok``; training moves collective bytes; per-device
  argument bytes are the sum of the rules' local shard shapes; the
  prefill FLOPs that ``FlopCounterMode`` counts are within 15 % of
  ``roofline.py``'s analytic forward count (the reference's
  ``test_analytic_flops_match_xla_dense_path``, rel 0.15).
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
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
warnings.filterwarnings("ignore")
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline as rl, specs as sp
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.common import reduced
from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.tree import flatten_with_path

out = {}
dryrun.start_fake_world(8)
with FakeTensorMode():
    x = torch.zeros(128, 4)
    with CollectiveCounter() as cc:
        funcol.wait_tensor(funcol.all_reduce(x, "sum", dist.group.WORLD))
out["all_reduce"] = cc.bytes()

mesh = make_test_mesh(data=2, model=4, device="cpu")
for arch in ("internlm2_1_8b", "llama4_scout_17b_a16e"):
    cfg = sp.dryrun_config(reduced(get_config(arch)), mesh)
    cells = {}
    for kind, seq, batch in (("train", 64, 16), ("prefill", 64, 16)):
        rec = dryrun.trace_cell(cfg, seq, batch, kind, mesh, "cpu")
        if kind == "train":
            analytic = rl.train_cost(cfg, seq, batch,
                                     rec["microbatches"]).flops
        else:
            analytic = rl.prefill_cost(cfg, seq, batch).flops
        # the rules' local shard bytes of the step's inputs
        with FakeTensorMode():
            p = sp.abstract_params(cfg, None if kind == "train"
                                   else torch.bfloat16, device="cpu")
            b = sp.train_batch_specs(cfg, seq, batch, device="cpu")
            trees = [(b, sh.batch_shardings(b, mesh))]
            if kind == "train":
                pb = sp.abstract_params(cfg, torch.bfloat16, device="cpu")
                ps = sh.params_shardings(pb, mesh, inference=rec["zero1"])
                o = make_optimizer(OptimizerConfig(kind=rec["optimizer"])
                                   ).init(pb)
                trees += [(pb, ps), (o, sh.params_shardings_like(
                    o, pb, ps, mesh))]
            else:
                trees.append((p, sh.params_shardings(
                    p, mesh, inference=rec["tp_only_params"])))
        expect = 0
        for tree, specs in trees:
            for path, leaf in flatten_with_path(tree):
                spec = specs
                for k in path:
                    spec = spec[k]
                expect += math.prod(sh.local_shape(
                    tuple(leaf.shape), spec, mesh)) * leaf.element_size()
        cells[kind] = {"rec": rec, "analytic_flops": analytic,
                       "expected_argument_bytes": expect}
    out[arch] = cells
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_RUN)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collective_counter_counts_one_all_reduce(traced):
    assert traced["all_reduce"] == {"all-reduce": 2048.0, "total": 2048.0}


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "llama4_scout_17b_a16e"])
def test_reduced_cells_trace_on_a_fake_mesh(traced, arch):
    cells = traced[arch]
    for kind, cell in cells.items():
        rec = cell["rec"]
        assert rec["mesh"] == {"data": 2, "model": 4}
        assert rec["memory"]["argument_size_in_bytes"] \
            == cell["expected_argument_bytes"], kind
        assert rec["memory"]["temp_size_in_bytes"] > 0
        assert rec["cost"]["flops"] > 0
    train = cells["train"]["rec"]
    assert train["collectives"]["total"] > 0
    assert train["microbatches"] == 8 and train["optimizer"] == "adamw_mp"
    prefill = cells["prefill"]
    assert prefill["rec"]["cost"]["flops"] == pytest.approx(
        prefill["analytic_flops"], rel=0.15)
