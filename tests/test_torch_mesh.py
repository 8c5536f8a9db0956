"""The port's sharded path on a (2, 2) mesh of four ``gloo`` CPU
processes, held to the single-device port (the JAX package's own
multi-device step fails, ROADMAP note (a)).

One group of four processes (``file://`` rendezvous under a temporary
directory, no fixed port) runs every check and writes its findings; the
tests read them:

* the sharded train step (params, AdamW state and batch laid out by the
  sharding rules, activation hints on, 2 microbatches of each rank's
  local rows): loss within 1e-6 of the single-device step, every param
  after the update within 1e-5 of its leaf's largest magnitude;
* ``decode_step`` through DTensor params and a DTensor decode state
  (sequence-sharded KV cache): logits of three steps within 1e-5;
* the elastic checkpoint, as the reference's
  ``test_elastic_checkpoint_across_mesh_shapes``: saved from the (2, 2)
  mesh, restored onto a (4, 1) mesh and onto plain tensors, bitwise.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4

_WORKER = r'''
import dataclasses, json, sys, warnings
import torch, torch.distributed as dist
warnings.filterwarnings("ignore")
rank, init, ckdir, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                        world_size=4)
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
from repro_torch.optim.adamw import OptimizerConfig, make_optimizer
from repro_torch.parallel import sharding as sh
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_path, leaves, tree_map

torch.manual_seed(0)
mesh = make_test_mesh(data=2, model=2, device="cpu")
cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                          act_dp_axes=("data",))
params = lm.init_lm(torch.Generator("cpu").manual_seed(0), cfg)
B, S = 8, 32
g = torch.Generator().manual_seed(1)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
         "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
res = {}

# -- train: one AdamW step with 2 microbatches ---------------------------
opt = make_optimizer(OptimizerConfig(lr=1e-3, warmup_steps=1))
pshard = sh.params_shardings(params, mesh)
dparams = sh.distribute(params, pshard, mesh)
state0 = opt.init(params)
dstate = sh.distribute(state0, sh.params_shardings_like(
    state0, params, pshard, mesh), mesh)
dbatch = sh.distribute(batch, sh.batch_shardings(batch, mesh), mesh)
step = make_train_step(cfg, opt, num_microbatches=2)
ref_p = tree_map(lambda p: p.clone(), params)
ref_p, _, ref_m = step(ref_p, opt.init(ref_p), batch)
dparams, dstate, m = step(dparams, dstate, dbatch)
res["loss"] = [float(m["loss"]), float(ref_m["loss"])]
errs = {"/".join(map(str, path)): float((a.full_tensor() - b).abs().max()
                                        / b.abs().max())
        for (path, b), a in zip(flatten_with_path(ref_p), leaves(dparams))}
res["param_err_leaf"] = max(errs, key=errs.get)
res["param_err"] = errs[res["param_err_leaf"]]
res["placements"] = sorted({str(x.placements) for x in leaves(dparams)})

# -- decode: three steps through DTensor params and state ------------------
dp = sh.distribute(params, sh.params_shardings(params, mesh, True), mesh)
state = lm.init_decode_state(cfg, B, 16, device="cpu")
dstate_dec = sh.distribute(state, sh.decode_state_shardings(state, mesh),
                           mesh)
res["kv_placements"] = str(leaves(dstate_dec)[0].placements)
errs = []
with torch.no_grad():
    for t in range(3):
        toks = batch["tokens"][:, t]
        ref_logits, state = lm.decode_step(params, cfg, state, toks, t)
        with sh.on_mesh():
            logits, dstate_dec = lm.decode_step(dp, cfg, dstate_dec, toks, t)
        errs.append(float((logits.full_tensor() - ref_logits).abs().max()))
res["decode_err"] = max(errs)

# -- elastic checkpoint: (2, 2) -> (4, 1) and plain -----------------------
ckpt.save({"params": dparams}, ckdir, 1)
template = {"params": params}
mesh41 = make_test_mesh(data=4, model=1, device="cpu")
back = ckpt.restore(template, ckdir, 1, shardings=sh.named(
    {"params": sh.params_shardings(params, mesh41)}, template, mesh41))
plain = ckpt.restore(template, ckdir)
full = [x.full_tensor() for x in leaves(dparams)]
res["ckpt_mesh41_equal"] = all(
    torch.equal(a.full_tensor(), b) for a, b in zip(leaves(back), full))
res["ckpt_mesh41_placements"] = sorted(
    {str(x.placements) for x in leaves(back)})
res["ckpt_plain_equal"] = all(
    torch.equal(a, b) and not isinstance(a, type(leaves(back)[0]))
    for a, b in zip(leaves(plain), full))
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    out = tmp / "result.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(tmp / "rendezvous"),
         str(tmp / "ckpt"), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(out.read_text())


def test_sharded_train_step_matches_the_single_device_step(mesh_run):
    loss, ref = mesh_run["loss"]
    assert abs(loss - ref) <= 1e-6
    assert mesh_run["param_err"] <= 1e-5, mesh_run["param_err_leaf"]
    # the rules shard something on both axes of the mesh
    assert any("Shard" in p for p in mesh_run["placements"])


def test_sharded_decode_matches_the_single_device_decode(mesh_run):
    assert mesh_run["kv_placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert mesh_run["decode_err"] <= 1e-5


def test_elastic_checkpoint_across_mesh_shapes(mesh_run):
    assert mesh_run["ckpt_mesh41_equal"]
    assert any("Shard" in p for p in mesh_run["ckpt_mesh41_placements"])
    assert mesh_run["ckpt_plain_equal"]
