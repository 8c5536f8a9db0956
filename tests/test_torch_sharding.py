"""The port's sharding rules and stand-ins against the JAX package's, on
the CPU.

* ``param_spec`` (through ``params_shardings``), ``batch_spec``,
  ``decode_state_spec`` and ``params_shardings_like`` (AdamW, Adafactor,
  ``adamw_mp`` states) give the reference's ``PartitionSpec`` read as a
  tuple, for every architecture's full config, scanned and unscanned, on
  16x16, 2x16x16, 2x4 and 2x2 meshes, for training and inference.
* ``specs.abstract_params`` / ``abstract_decode_state`` /
  ``train_batch_specs`` / ``decode_token_specs`` have the reference's
  tree, shapes and dtypes.
* ``to_placements``: each rank's block on a (pod, data, model) = (2, 2, 2)
  mesh (global offset and local shape, as DTensor lays it out) is the
  block ``jax.sharding.NamedSharding.devices_indices_map`` gives the
  device at the same mesh position, run in a subprocess with 8 host
  devices.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel import sharding as jax_sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "2x2": {"data": 2, "model": 2}}
OPT_KINDS = ["adamw", "adafactor", "adamw_mp"]


def _stub(shape):
    """A mesh as the rules read it: ``.shape`` maps names to sizes."""
    return types.SimpleNamespace(shape=dict(shape))


def _jax_mesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _jax_path(path):
    return tuple(getattr(p, "key", getattr(p, "name", str(p)))
                 for p in path)


def _jax_leaves(tree):
    return {_jax_path(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {tuple(str(k) for k in p): x for p, x in flatten_with_path(tree)}


def _spec_leaves(specs_tree, like):
    """The spec of each leaf of ``like`` (specs are tuples, which a tree
    walk would descend into)."""
    out = {}
    for p, _ in flatten_with_path(like):
        node = specs_tree
        for k in p:
            node = node[k]
        out[tuple(str(k) for k in p)] = node
    return out


@functools.lru_cache(maxsize=None)
def _trees(arch, scanned):
    """(reference abstract params, the port's fake params), full config."""
    jcfg = dataclasses.replace(jax_config(arch), scan_layers=scanned)
    tcfg = dataclasses.replace(get_config(arch), scan_layers=scanned)
    return (jax_specs.abstract_params(jcfg),
            specs.abstract_params(tcfg, device="cpu"))


@pytest.mark.parametrize("scanned", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, scanned):
    jtree, ttree = _trees(arch, scanned)
    jl, tl = _jax_leaves(jtree), _port_leaves(ttree)
    assert jl.keys() == tl.keys()
    for path, leaf in jl.items():
        assert tuple(tl[path].shape) == leaf.shape, path
        assert str(tl[path].dtype).split(".")[-1] == str(leaf.dtype), path
    for mesh in MESHES.values():
        for inference in (False, True):
            ours = _spec_leaves(sh.params_shardings(
                ttree, _stub(mesh), inference=inference), ttree)
            for path, leaf in jl.items():
                ref = jax_sh.param_spec(path, leaf.shape, _stub(mesh),
                                        "scan" in path, inference)
                assert ours[path] == tuple(ref), (path, mesh, inference)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs_equal_the_references(arch):
    jtree, ttree = _trees(arch, True)
    for kind in OPT_KINDS:
        jopt = jax.eval_shape(
            jax_adamw.make_optimizer(jax_adamw.OptimizerConfig(kind=kind))
            .init, jtree)
        # a full-size state, never allocated: in the params' fake mode
        with flatten_with_path(ttree)[0][1].fake_mode:
            topt = adamw.make_optimizer(adamw.OptimizerConfig(kind=kind)
                                        ).init(ttree)
        for name, shape in MESHES.items():
            for inference in (False, True):
                jm = _jax_mesh(shape)
                ref = jax_sh.params_shardings_like(
                    jopt, jtree, jax_sh.params_shardings(jtree, jm,
                                                         inference), jm)
                ours = sh.params_shardings_like(
                    topt, ttree, sh.params_shardings(ttree, _stub(shape),
                                                     inference),
                    _stub(shape))
                rl = {p: tuple(s.spec) for p, s in _jax_leaves(
                    ref).items()}
                assert rl == _spec_leaves(ours, topt), (kind, name,
                                                        inference)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_state_specs_equal_the_references(arch):
    jcfg = jax_specs.dryrun_config(jax_config(arch))
    tcfg = specs.dryrun_config(get_config(arch))
    for seq, batch, kind in jax_specs.SHAPES.values():
        if kind == "decode":
            jtree = jax_specs.abstract_decode_state(jcfg, batch, seq)
            ttree = specs.abstract_decode_state(tcfg, batch, seq,
                                                device="cpu")
            jtok, jpos = jax_specs.decode_token_specs(batch)
            ttok, tpos = specs.decode_token_specs(batch, device="cpu")
            assert (tuple(ttok.shape), ttok.dtype) == (jtok.shape,
                                                       torch.int32)
            assert (tuple(tpos.shape), tpos.dtype) == ((), torch.int32)
        else:
            jtree = jax_specs.train_batch_specs(jcfg, seq, batch)
            ttree = specs.train_batch_specs(tcfg, seq, batch, device="cpu")
        jl, tl = _jax_leaves(jtree), _port_leaves(ttree)
        assert jl.keys() == tl.keys()
        for path, leaf in jl.items():
            assert tuple(tl[path].shape) == leaf.shape, path
            assert str(tl[path].dtype).split(".")[-1] == str(leaf.dtype)
        for shape in MESHES.values():
            if kind == "decode":
                ours = _spec_leaves(sh.decode_state_shardings(
                    ttree, _stub(shape)), ttree)
                for path, leaf in jl.items():
                    ref = jax_sh.decode_state_spec(
                        path, leaf.shape, _stub(shape), "scan" in path)
                    assert ours[path] == tuple(ref), (path, shape)
            else:
                ours = _spec_leaves(sh.batch_shardings(ttree, _stub(shape)),
                                    ttree)
                for path, leaf in jl.items():
                    ref = jax_sh.batch_spec(leaf.shape, _stub(shape))
                    assert ours[path] == tuple(ref), (path, shape)


def test_spec_helpers():
    mesh = types.SimpleNamespace(shape=(2, 2, 2),
                                 mesh_dim_names=("pod", "data", "model"))
    assert sh.axis_sizes(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert sh.replicated(mesh) == () == tuple(jax_sh.replicated(
        _jax_mesh(MESHES["2x2"])).spec)
    assert sh.local_shape((8, 6, 4), (("pod", "data"), "model"), mesh) \
        == (2, 3, 4)
    with pytest.raises(ValueError):
        sh.to_placements((("data", "pod"),), mesh)


_OFFSETS = """
import dataclasses, json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np, types
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor._utils import \\
    _compute_local_shape_and_global_offset
from repro.configs import get_config as jax_config
from repro.launch import specs as jax_specs
from repro.parallel import sharding as jax_sh
from repro_torch.parallel import sharding as sh

names = ("pod", "data", "model")
devs = np.array(jax.devices()).reshape(2, 2, 2)
mesh = Mesh(devs, names)
port_mesh = types.SimpleNamespace(shape=(2, 2, 2), mesh_dim_names=names)

def leaves(tree, fn):
    return [(p, x, fn(p, x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]

def key(p):
    return tuple(getattr(k, "key", str(k)) for k in p)

checked = mismatched = 0
for arch in ("internlm2_1_8b", "llama4_scout_17b_a16e", "xlstm_1_3b"):
    cfg = jax_specs.dryrun_config(jax_config(arch))
    items = leaves(jax_specs.abstract_params(cfg),
                   lambda p, x: tuple(jax_sh.param_spec(
                       key(p), x.shape, mesh, "scan" in key(p))))
    items += leaves(jax_specs.abstract_decode_state(cfg, 8, 64),
                    lambda p, x: tuple(jax_sh.decode_state_spec(
                        key(p), x.shape, mesh, "scan" in key(p))))
    items += leaves(jax_specs.train_batch_specs(cfg, 64, 8),
                    lambda p, x: tuple(jax_sh.batch_spec(x.shape, mesh)))
    for p, x, spec in items:
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(x.shape)
        pl = sh.to_placements(spec, port_mesh)
        for coord in np.ndindex(2, 2, 2):
            ref = idx[devs[coord]]
            start = tuple((s.start or 0) for s in ref)
            size = tuple(len(range(*s.indices(n)))
                         for s, n in zip(ref, x.shape))
            shape, off = _compute_local_shape_and_global_offset(
                x.shape, (2, 2, 2), list(coord), pl)
            checked += 1
            mismatched += (tuple(shape), tuple(off)) != (size, start)
print(json.dumps({"checked": checked, "mismatched": mismatched}))
"""


def test_rank_blocks_equal_jax_devices_indices_map():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_OFFSETS)],
                         capture_output=True, text=True, env=env,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["checked"] > 1000 and res["mismatched"] == 0, res


def test_slice_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract does "
                    "not apply")
    from repro_torch.launch import mesh
    cfg = get_config("internlm2_1_8b")
    for call in (lambda: specs.abstract_params(cfg),
                 lambda: specs.abstract_decode_state(cfg, 2, 8),
                 lambda: specs.train_batch_specs(cfg, 8, 2),
                 lambda: specs.decode_token_specs(2),
                 lambda: mesh.make_test_mesh(),
                 lambda: mesh.make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
