"""The one-token attention decode around the ``decode_attn`` kernel, on
the CPU (the kernel itself runs on the card: tests/test_torch_gpu.py).

* ``attention_decode`` on the plain path equals the step it replaced
  (RoPE in ``_project_qkv``, the cache write, the mask, ``_sdpa``) bit
  for bit, outputs and caches, over rings that wrap, with scalar and
  per-row positions, for full, 2d and no RoPE, qkv bias and a local
  window;
* the selection rule (``decode_attn.ops.plain_reason``): fake CUDA bf16
  tensors of the built head widths take the kernel, the CPU, other
  dtypes and other widths do not (DTensor caches:
  tests/test_torch_mesh.py); CUDA tensors of a layout or head group the
  kernel does not take are not sent to the plain version but raise in
  the wrapper; a traced step counts its path;
* what the kernel relies on: the full-attention and the local-window
  rules keep the same slots, the kept RoPE frequencies are the ones
  ``apply_rope`` computes, and the wrapper takes CUDA tensors only.
"""
import dataclasses
import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import _rope_freqs, apply_rope  # noqa: E402


def _previous_attention_decode(p, x, cfg, cache, pos):
    """``attention_decode`` as it was before the kernel, verbatim but for
    the DTensor branch (the plain path's, unchanged; on a mesh in
    tests/test_torch_mesh.py)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long()
    per_row = pos.ndim == 1
    positions = pos[:, None] if per_row else pos.expand(B, 1)
    q, k, v = attn._project_qkv(p, x, cfg, positions)
    C = cache["k"].shape[1]
    slot = pos % C
    idx = torch.arange(C, device=x.device)
    if per_row:
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        cache["k"].index_copy_(1, slot.view(1), k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot.view(1), v.to(cache["v"].dtype))
    if cfg.attn_kind == "local":
        if per_row:
            valid = (idx[None, :] <= slot[:, None]) | (pos[:, None] >= C)
        else:
            valid = (idx <= slot) | (pos >= C)
    else:
        valid = idx[None, :] <= pos[:, None] if per_row else idx <= pos
    mask = (valid[:, None, None, None, :] if per_row
            else valid[None, None, None, None, :])
    out = attn._sdpa(q, cache["k"], cache["v"], mask, cfg)
    out = out @ p["wo"].to(x.dtype)
    return out, {"k": cache["k"], "v": cache["v"]}


# the smoke configs of each decode variant: full RoPE, ChatGLM's 2d RoPE,
# qkv bias, a local window (recurrentgemma: 1 KV head, window 16), and
# RoPE off
VARIANTS = {
    "internlm2": ("internlm2_1_8b", {}),
    "chatglm3_2d": ("chatglm3_6b", {}),
    "qwen25_bias": ("qwen25_32b", {}),
    "recurrentgemma_local": ("recurrentgemma_2b", {}),
    "no_rope": ("internlm2_1_8b", {"rope_kind": "none"}),
}


def _variant(name, dtype):
    arch, over = VARIANTS[name]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    gen = torch.Generator().manual_seed(7)
    p = attn.init_attention(gen, cfg)
    if cfg.qkv_bias:
        for key in ("bq", "bk", "bv"):
            p[key] = torch.randn(p[key].shape, generator=gen)
    return cfg, p


@pytest.mark.parametrize("positions", ["scalar", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_path_equals_the_previous_decode_bitwise(variant, dtype,
                                                       positions):
    """20 steps over a ring of 8 slots (recurrentgemma's window of 16 is
    cut to 8 by max_len): the ring wraps twice; per-row positions start
    each row at its own offset, so rows wrap at different steps."""
    cfg, p = _variant(variant, dtype)
    B, C = 3, 8
    ours = attn.init_kv_cache(cfg, B, C, dtype)
    ref = attn.init_kv_cache(cfg, B, C, dtype)
    gen = torch.Generator().manual_seed(3)
    start = torch.tensor([0, 3, 11])
    for t in range(20):
        x = torch.randn((B, 1, cfg.d_model), generator=gen).to(dtype)
        pos = t if positions == "scalar" else start + t
        out, ours = attn.attention_decode(p, x, cfg, ours, pos)
        want, ref = _previous_attention_decode(p, x, cfg, ref, pos)
        assert torch.equal(out, want), (variant, t)
        assert torch.equal(ours["k"], ref["k"]), (variant, t)
        assert torch.equal(ours["v"], ref["v"]), (variant, t)


def _fake(shape, dtype=torch.bfloat16, device="cuda"):
    return torch.empty(shape, dtype=dtype, device=device)


def _reason(B=16, H=16, KV=8, hd=128, C=128, **kw):
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = _fake((B, 1, H, hd), **kw)
        ck, cv = _fake((B, C, KV, hd), **kw), _fake((B, C, KV, hd), **kw)
        return ops.plain_reason(q, ck, cv)


@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
@pytest.mark.parametrize("H,KV", [(16, 8), (10, 1), (32, 2), (40, 8),
                                  (16, 16)])
def test_cuda_bf16_caches_of_the_built_widths_take_the_kernel(H, KV, hd):
    """internlm2 (16/8), recurrentgemma (10/1), chatglm3 (32/2), qwen2.5
    and llama4 (40/8), seamless (16/16) head groups at every built
    width: no reason for the plain path."""
    assert _reason(H=H, KV=KV, hd=hd) is None


@pytest.mark.parametrize("case,reason", [
    (dict(device="cpu"), "device"),
    (dict(dtype=torch.float32), "dtype"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(hd=160), "head_dim"),          # pixtral_12b
    (dict(hd=512), "head_dim"),
    (dict(hd=16), "head_dim"),           # the smoke configs
])
def test_other_caches_keep_the_plain_path(case, reason):
    assert _reason(**case) == reason


class _Launched(Exception):
    pass


def _wrapper_error(q, ck, cv, freqs=None):
    """The wrapper on fake CUDA tensors: what it raises, or None where it
    passes every check of shapes, dtypes, devices, layouts and
    frequencies (stopped at the launch: nothing is built or run)."""
    B, KV, hd = q.shape[0], ck.shape[2], q.shape[-1]
    kv = _fake((B, 1, KV, hd))
    with mock.patch.object(ops.build, "entry", side_effect=_Launched), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")          # a fake tensor's data_ptr
        try:
            ops.decode_attn(q, kv, kv, ck, cv, _fake((), torch.int64), freqs)
        except ValueError as e:
            return str(e)
        except (_Launched, RuntimeError):   # RuntimeError: a fake
            return None                     # tensor's data_ptr (newer torch)
    raise AssertionError("the wrapper returned without a launch")


def test_strided_caches_and_queries_raise_instead_of_the_plain_path():
    """A cache or query that is not one contiguous block (here a view of
    every other head's width) takes no plain path: ``plain_reason``
    finds none and the wrapper raises (a base pointer off 16 bytes too,
    on the card: tests/test_torch_gpu.py)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = _fake((4, 1, 16, 128))
        ck = _fake((4, 8, 8, 128))
        strided = torch.empty_strided((4, 8, 8, 128), (8 * 8 * 256, 8 * 256,
                                                       256, 1),
                                      dtype=torch.bfloat16, device="cuda")
        q_strided = torch.empty_strided((4, 1, 16, 128), (4096, 4096, 256,
                                                          1),
                                        dtype=torch.bfloat16, device="cuda")
        for args in ((q, strided, ck), (q, ck, strided), (q_strided, ck, ck)):
            assert ops.plain_reason(*args) is None
            assert "contiguous" in _wrapper_error(*args)
        assert _wrapper_error(q, ck, ck) is None


@pytest.mark.parametrize("H,KV", [(64, 2), (34, 2), (12, 8)])
def test_head_groups_the_kernel_cannot_take_raise(H, KV):
    """32 or 17 query heads a KV head (over MAX_GROUP), or heads that are
    not a whole number of groups: no plain path, the plan raises."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = _fake((4, 1, H, 128))
        ck = _fake((4, 8, KV, 128))
        assert ops.plain_reason(q, ck, ck) is None
        assert "decode_attn" in _wrapper_error(q, ck, ck)


@pytest.mark.parametrize("freqs,what", [
    (dict(shape=(32,), dtype=torch.float64), "fp32"),
    (dict(shape=(80,)), "2 R <= 128"),
    (dict(shape=(8, 4)), "(R,)"),
    (dict(shape=(32,), device="cpu"), "on cuda"),
])
def test_the_wrapper_checks_the_rope_frequencies(freqs, what):
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = _fake((4, 1, 16, 128))
        ck = _fake((4, 8, 8, 128))
        f = _fake(freqs["shape"], dtype=freqs.get("dtype", torch.float32),
                  device=freqs.get("device", "cuda"))
        assert what in _wrapper_error(q, ck, ck, f)
        good = _fake((64,), dtype=torch.float32)
        assert _wrapper_error(q, ck, ck, good) is None


def test_a_traced_step_counts_its_path():
    cfg, p = _variant("internlm2", torch.float32)
    cache = attn.init_kv_cache(cfg, 2, 8, torch.float32)
    x = torch.randn((2, 1, cfg.d_model))
    obs.reset()
    obs.enable()
    try:
        for t in range(3):
            attn.attention_decode(p, x, cfg, cache, t)
        m = obs.metrics()
        counts = (m.value("decode_attn.fused"),
                  m.value("decode_attn.plain", reason="device"))
    finally:
        obs.disable()
        obs.reset()
    assert counts == (0, 3)


@pytest.mark.parametrize("C", [1, 5, 16, 128])
def test_full_and_local_rules_keep_the_first_min_pos_plus_one_slots(C):
    """The kernel reads slots t < min(pos + 1, C): what both of the plain
    version's masks keep, for every position up to three wraps."""
    idx = torch.arange(C)
    for pos in range(3 * C + 2):
        want = idx < min(pos + 1, C)
        full = idx <= pos
        local = (idx <= pos % C) | torch.tensor(pos >= C)
        assert torch.equal(full, want) and torch.equal(local, want), pos


@pytest.mark.parametrize("kind", ["full", "2d", "none"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_rope_table_is_kept_and_equals_apply_ropes_frequencies(hd, kind):
    """The kept table is what apply_rope builds (R = hd / 2 pairs for
    "full", hd / 4 for "2d", none for "none"), and turning q by it as
    the kernel does (pair i by pos * freqs[i], the rest passed through)
    is apply_rope bit for bit."""
    dev = torch.device("cpu")
    f = attn.rope_table(kind, hd, dev)
    assert f is attn.rope_table(kind, hd, dev)
    if kind == "none":
        assert f is None
        return
    rot = hd if kind == "full" else hd // 2
    assert torch.equal(f, _rope_freqs(rot, device=dev))
    assert f.dtype == torch.float32 and f.shape == (rot // 2,)
    x = torch.randn((3, 1, 2, hd)).bfloat16()
    pos = torch.tensor([0, 7, 5000])
    ang = pos[:, None].float() * f                       # (3, R)
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    x0, x1 = x[..., :rot:2].float(), x[..., 1:rot:2].float()
    y = x.clone()
    y[..., :rot:2] = (x0 * c - x1 * s).bfloat16()
    y[..., 1:rot:2] = (x1 * c + x0 * s).bfloat16()
    assert torch.equal(y, apply_rope(x, pos[:, None], kind))


@pytest.mark.parametrize("hd", ops.HEAD_DIMS)
def test_score_scale_is_the_fp32_reciprocal_of_the_fp32_divisor(hd):
    s = ops.score_scale(hd)
    assert s == float(np.float32(1) / np.float32(np.sqrt(hd)))
    assert s == float(np.float32(s))


def test_the_wrapper_takes_cuda_tensors_only():
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((2, 1, 2, 64), dtype=torch.bfloat16)
    cache = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    n = ops.decode_attn.launches
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attn(q, kv, kv, cache, cache.clone(), torch.tensor(3))
    assert ops.decode_attn.launches == n
