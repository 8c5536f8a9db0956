"""The port's optimizers, gradient compression and checkpoints against
the JAX package, on the CPU.

* Each optimizer kind (adamw, adamw_bf16, adamw_mp, adafactor): three
  updates from the same params and gradients (made with numpy), every
  param and state leaf within OPT_RTOL; ``cosine_lr`` within one fp32
  ulp; reference note (h) (weight decay and Adafactor's factoring follow
  ``ndim >= 2``, so a scanned stack's norm scales are decayed) pinned in
  both packages.
* ``compress_with_feedback``: bitwise equal over three error-feedback
  rounds.
* Checkpoints: the same files and keys; a checkpoint of either package
  restores in the other; the atomic ``.tmp``; an async snapshot that a
  later in-place update does not reach.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import compression as jax_comp  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

from test_torch_families import _numpy_tree  # noqa: E402

# three updates in fp32 with the same inputs: the two packages may round
# cos / pow (the lr, bias corrections, Adafactor's decay) one ulp apart
# and contract a multiply-add differently
OPT_RTOL = 1e-6
KINDS = ["adamw", "adamw_bf16", "adamw_mp", "adafactor"]


def _np_params(rng):
    """A 2-D matrix, a vector and a stacked (3-D) leaf in nested dicts."""
    return {"w": rng.normal(0, 1, (4, 6)).astype(np.float32),
            "b": rng.normal(0, 1, (6,)).astype(np.float32),
            "stack": {"scan": {"w": rng.normal(0, 1, (3, 4, 5))
                               .astype(np.float32)}}}


def _np_tree(tree):
    """Leaf arrays of either package's tree, keyed by path."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().copy()
    return np.asarray(tree).astype(np.float32)


def _assert_trees_close(ours, ref, rtol, path=()):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for k in ref:
            _assert_trees_close(ours[k], ref[k], rtol, path + (k,))
        return
    assert np.shape(ours) == np.shape(ref), path
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0,
                               err_msg=str(path))


@pytest.mark.parametrize("kind,dtype", [(k, "float32") for k in KINDS]
                         + [("adamw_mp", "bfloat16")])
def test_optimizer_updates_match_jax(kind, dtype):
    rng = np.random.default_rng(KINDS.index(kind))
    cfg_kw = dict(kind=kind, lr=0.05, warmup_steps=2, total_steps=10,
                  weight_decay=0.1)
    p_np = _np_params(rng)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(0, 2, a.shape).astype(np.float32), p_np)
        for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    opt_j = jax_adamw.make_optimizer(jax_adamw.OptimizerConfig(**cfg_kw))
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p_np)
    sj = opt_j.init(pj)
    opt_t = adamw.make_optimizer(adamw.OptimizerConfig(**cfg_kw))
    pt = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    st = opt_t.init(pt)
    for g in grads:
        pj, sj = opt_j.update(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jdt), g), sj, pj)
        pt, st = opt_t.update(jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), g), st, pt)
        # bf16 leaves round the fp32 results once more: one bf16 ulp
        rtol = 2.0 ** -8 if dtype == "bfloat16" else OPT_RTOL
        _assert_trees_close(_np_tree(pt), _np_tree(pj), rtol)
        state_j = {k: v for k, v in sj.items() if k != "step"}
        state_t = {k: v for k, v in st.items() if k != "step"}
        _assert_trees_close(_np_tree(state_t), _np_tree(state_j),
                            2.0 ** -8 if kind == "adamw_bf16" else OPT_RTOL)
        assert st["step"].dtype == torch.int32
        assert int(st["step"]) == int(sj["step"])


def test_update_writes_in_place_and_returns_the_same_trees():
    p = {"w": torch.ones((3, 3)), "b": torch.ones(3)}
    ids = {k: v.data_ptr() for k, v in p.items()}
    opt = adamw.make_optimizer(adamw.OptimizerConfig(lr=0.1, warmup_steps=1))
    st = opt.init(p)
    g = {"w": torch.full((3, 3), 0.5), "b": torch.full((3,), -0.5)}
    new_p, new_st = opt.update(g, st, p)
    assert new_p is p and {k: v.data_ptr() for k, v in p.items()} == ids
    assert new_st["m"] is st["m"] and float(p["b"][0]) > 1.0
    assert not any(t.requires_grad for t in leaves(new_st))


def test_cosine_lr_within_one_ulp():
    for cfg in (jax_adamw.OptimizerConfig(),
                jax_adamw.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                          total_steps=37),
                jax_adamw.OptimizerConfig(warmup_steps=0, total_steps=5)):
        tcfg = adamw.OptimizerConfig(**dataclasses.asdict(cfg))
        for step in (0, 1, 3, 9, 10, 11, 25, 36, 37, 100, 5000, 20000):
            a = float(jax_adamw.cosine_lr(cfg, jnp.int32(step)))
            b = adamw.cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32))
            assert b.dtype == torch.float32
            ulp = np.spacing(np.float32(max(abs(a), abs(float(b)))))
            assert abs(a - float(b)) <= ulp, (step, a, float(b))


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(9)
    g = _np_params(rng)
    gt = jax.tree_util.tree_map(torch.from_numpy, g)
    n_j = float(jax_adamw.global_norm(g))
    np.testing.assert_allclose(float(adamw.global_norm(gt)), n_j,
                               rtol=OPT_RTOL)
    cj, nj = jax_adamw.clip_by_global_norm(g, 1.0)
    ct, nt = adamw.clip_by_global_norm(gt, 1.0)
    assert n_j > 1.0
    _assert_trees_close(_np_tree(ct), _np_tree(cj), OPT_RTOL)


def _scanned_params(scan):
    """The 4-layer internlm2 smoke model's params on the reference's init
    with every norm scale set to 1 (init is 0, which no decay moves), and
    the port's own init's tree layout."""
    over = dict(n_layers=4, scan_layers=scan)
    cfg_j = dataclasses.replace(jax_smoke("internlm2_1_8b"), **over)
    cfg_t = dataclasses.replace(get_smoke_config("internlm2_1_8b"), **over)
    pj = _numpy_tree(jax.jit(lambda k: jax_lm.init_lm(k, cfg_j))(
        jax.random.PRNGKey(0)))

    def ones_for_norms(tree):
        return {k: (ones_for_norms(v) if isinstance(v, dict) else
                    np.ones_like(v) if k.startswith("ln") else v)
                for k, v in tree.items()}
    layout = jax.tree_util.tree_map(
        lambda t: tuple(t.shape),
        lm.init_lm(torch.Generator().manual_seed(0), cfg_t))
    return ones_for_norms(pj), layout


@pytest.mark.parametrize("scan", [True, False])
def test_note_h_stacked_norms_are_decayed_and_factored(scan):
    """Reference note (h): weight decay applies to ``p.ndim >= 2`` and
    Adafactor factors the same leaves, so under ``scan_layers=True`` the
    norm scales, stacked to (n_groups, d), are decayed and factored; under
    ``scan_layers=False`` they are not. Both packages agree."""
    pj, layout = _scanned_params(scan)
    assert layout == jax.tree_util.tree_map(np.shape, pj)
    ln1 = (("stack", "scan", "p0", "ln1") if scan
           else ("stack", "tail_0", "ln1"))
    shape = (4, 64) if scan else (64,)
    kw = dict(lr=0.1, warmup_steps=1, weight_decay=0.1)
    for kind in ("adamw", "adafactor"):
        ours = lm.params_from_numpy(pj, "cpu")
        opt_t = adamw.make_optimizer(adamw.OptimizerConfig(kind=kind, **kw))
        st = opt_t.init(ours)
        zeros_t = jax.tree_util.tree_map(torch.zeros_like, ours)
        ours, st = opt_t.update(zeros_t, st, ours)
        opt_j = jax_adamw.make_optimizer(
            jax_adamw.OptimizerConfig(kind=kind, **kw))
        ref = jax.tree_util.tree_map(jnp.asarray, pj)
        sj = opt_j.init(ref)
        ref, sj = jax.jit(opt_j.update)(
            jax.tree_util.tree_map(jnp.zeros_like, ref), sj, ref)
        node_t, node_j = ours, ref
        for k in ln1:
            node_t, node_j = node_t[k], node_j[k]
        assert tuple(node_t.shape) == shape
        np.testing.assert_allclose(node_t.numpy(), np.asarray(node_j),
                                   rtol=OPT_RTOL)
        decayed = not np.allclose(node_t.numpy(), 1.0)
        assert decayed == scan, kind
        if kind == "adafactor":
            vr, vc = st["vr"], st["vc"]
            for k in ln1:
                vr, vc = vr[k], vc[k]
            factored = ((4,), (64,)) if scan else ((64,), (1,))
            assert (tuple(vr.shape), tuple(vc.shape)) == factored


# -- gradient compression ----------------------------------------------------


def test_compress_with_feedback_bitwise():
    rng = np.random.default_rng(11)
    g0 = {"w": rng.normal(0, 1, (16, 8)).astype(np.float32),
          "n": {"b": rng.normal(0, 1e-3, (8,)).astype(np.float32),
                # exact half-steps: 63.5 and 2.5 round to even
                "t": np.array([127.0, 63.5, -0.5, 2.5, 0.0], np.float32)},
          "z": np.zeros((3,), np.float32)}
    ej = jax_comp.init_error_state(g0)
    et = comp.init_error_state(jax.tree_util.tree_map(torch.from_numpy, g0))
    for i in range(3):
        g = jax.tree_util.tree_map(lambda a: a * (1 + 0.37 * i), g0)
        dj, ej = jax_comp.compress_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), ej)
        dt, et = comp.compress_with_feedback(
            jax.tree_util.tree_map(torch.from_numpy, g), et)
        for a, b in zip(jax.tree_util.tree_leaves(dj) +
                        jax.tree_util.tree_leaves(ej),
                        leaves(dt) + leaves(et)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    qj, sj = jax_comp.compress_leaf(jnp.asarray(g0["n"]["t"]))
    qt, st = comp.compress_leaf(torch.from_numpy(g0["n"]["t"]))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.tolist() == [127, 64, 0, 2, 0] and float(st) == float(sj)
    np.testing.assert_array_equal(
        comp.decompress_leaf(qt, st, torch.bfloat16).float().numpy(),
        np.asarray(jax_comp.decompress_leaf(qj, sj, jnp.bfloat16),
                   np.float32))


# -- checkpoints -------------------------------------------------------------


def _ckpt_tree(rng):
    p = _np_params(rng)
    return p, {"params": p, "opt": {"m": {"w": p["w"] * 0.5},
                                    "step": np.int32(3)},
               "step": np.int32(7)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def test_checkpoint_files_and_keys_match_jax(tmp_path):
    _, tree = _ckpt_tree(np.random.default_rng(1))
    ckpt.save(_to_torch(tree), tmp_path / "torch", 7)
    jax_ckpt.save(jax.tree_util.tree_map(jnp.asarray, tree),
                  tmp_path / "jax", 7)
    a, b = (tmp_path / d / "step_00000007" for d in ("torch", "jax"))
    assert sorted(p.name for p in a.iterdir()) == ["arrays.npz",
                                                   "meta.json"]
    ma, mb = (json.loads((d / "meta.json").read_text()) for d in (a, b))
    assert ma == mb
    with np.load(a / "arrays.npz") as fa, np.load(b / "arrays.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert "params__stack__scan__w" in fa.files
        for k in fb.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k])
    assert ckpt.latest_step(tmp_path / "jax") == 7


def test_checkpoint_restores_across_packages(tmp_path):
    p, tree = _ckpt_tree(np.random.default_rng(2))
    # the reference's checkpoint into the port's template (fp32 + int32)
    jax_ckpt.save(jax.tree_util.tree_map(jnp.asarray, tree), tmp_path, 1)
    tmpl = _to_torch(tree)
    tmpl["step"] = np.zeros((), np.int32)
    out = ckpt.restore(tmpl, tmp_path, 1)
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["step"]) == 7 and isinstance(out["step"], np.ndarray)
    for (path, a), (_, b) in zip(flatten_with_path(out),
                                 flatten_with_path(tree)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    # the port's, with a bf16 leaf (written as float32), into the
    # reference's template
    ours = _to_torch(tree)
    ours["params"]["b"] = ours["params"]["b"].to(torch.bfloat16)
    ckpt.save(ours, tmp_path, 2)
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as f:
        assert f["params__b"].dtype == np.float32
    tj = jax.tree_util.tree_map(jnp.asarray, tree)
    tj["params"]["b"] = tj["params"]["b"].astype(jnp.bfloat16)
    back = jax_ckpt.restore(tj, tmp_path, 2)
    assert back["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["b"], np.float32),
        ours["params"]["b"].float().numpy())
    np.testing.assert_array_equal(np.asarray(back["params"]["stack"]["scan"]
                                             ["w"]), p["stack"]["scan"]["w"])
    mine = ckpt.restore(ours, tmp_path)
    assert mine["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(mine["params"]["b"], ours["params"]["b"])


def test_checkpoint_atomic_keeps_previous(tmp_path):
    t1 = {"w": torch.ones((2, 2))}
    ckpt.save(t1, tmp_path, 1)
    # a stale tmp dir from a crashed writer must not break anything
    (tmp_path / "step_00000002.tmp").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    assert torch.equal(ckpt.restore(t1, tmp_path)["w"], torch.ones((2, 2)))
    ckpt.save({"w": torch.zeros((2, 2))}, tmp_path, 2)
    assert not (tmp_path / "step_00000002.tmp").exists()
    assert ckpt.latest_step(tmp_path) == 2
    with pytest.raises(FileNotFoundError):
        ckpt.restore(t1, tmp_path / "none")


def test_async_snapshot_is_not_reached_by_a_later_in_place_update(
        tmp_path, monkeypatch):
    """``save_async`` copies every leaf before it returns: an in-place
    optimizer step taken while the write is still queued does not reach
    the checkpoint (on the CPU a tensor's ``numpy()`` is a view)."""
    release = threading.Event()
    real_save = ckpt.save

    def held_save(*a, **k):
        assert release.wait(30)
        return real_save(*a, **k)
    monkeypatch.setattr(ckpt, "save", held_save)
    acp = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    tree = {"w": torch.zeros((4,)), "b": torch.zeros((2,), dtype=
                                                     torch.bfloat16)}
    acp.save_async(tree, 1)
    with torch.no_grad():
        tree["w"].add_(5.0)
        tree["b"].add_(5.0)
    release.set()
    acp.wait()
    out = ckpt.restore(tree, tmp_path, 1)
    assert torch.equal(out["w"], torch.zeros(4))
    assert torch.equal(out["b"], torch.zeros(2, dtype=torch.bfloat16))
    for s in (2, 3):
        acp.save_async(tree, s)
    acp.wait()
    assert ckpt.latest_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    acp.close()
    assert not acp._worker.is_alive()
