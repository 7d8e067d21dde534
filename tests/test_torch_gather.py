"""The port's gather backward (``cuda_kernels.gather_backward``) on the CPU.

The kernel on the card sums each output row's contributions in f32, in
ascending contribution order, and is held bit for bit against its plain twin
``gather_backward_torch`` run on the host (chip_smoke.py, phase 2). Here the
twin itself is held bit for bit against a serial numpy f32 loop in that
order, in both forms (unweighted, and weighted with k = 1, 3, 4 weights a
row), with duplicate and out-of-range indices; and the weighted form against
the JAX package's ``gather_bwd_pallas`` (interpret mode) applied to JAX's own
``g * w`` products. The kernel path of the wrapper runs through
``test_torch_ops.fake_kernels``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3d_tpu.ops import pallas_kernels as pk
from mm3d_tpu_torch import ops as tops
from mm3d_tpu_torch.ops import cuda_kernels as ck
from test_torch_ops import fake_kernels


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values rounded to ``dtype`` (round to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        getattr(torch, dtype)).float().numpy()


def _serial(g, idx, n, w, dtype):
    """d[b, idx[b,f]] += contribution f, one f32 add at a time in ascending
    f, from +0; contribution f = r*k + j is rnd(g[b,r] * w[b,r,j]) (f32
    product), or g[b,f] unweighted; indices outside [0, n) skipped; the sums
    rounded to ``dtype``."""
    B, C = g.shape[0], g.shape[-1]
    if w is None:
        contrib = g.reshape(B, -1, C)
    else:
        contrib = _round(g[:, :, None, :] * w[..., None], dtype).reshape(
            B, -1, C)
    rows = idx.reshape(B, -1)
    d = np.zeros((B, n, C), np.float32)
    for b in range(B):
        for f in range(rows.shape[1]):
            r = rows[b, f]
            if 0 <= r < n:
                d[b, r] = d[b, r] + contrib[b, f]
    return _round(d, dtype)


def _inputs(seed, B, R, k, C, n, dtype, weighted):
    """Values over many binades, in ``dtype``; indices with duplicates,
    -1, n and a large one out of range."""
    r = np.random.RandomState(seed)
    g = _round(r.randn(B, R, C) * 2.0 ** r.randint(-20, 20, (B, R, 1)),
               dtype)
    shape = (B, R, k) if weighted else (B, R)
    idx = r.randint(0, n, shape).astype(np.int32)
    idx.reshape(-1)[::7] = idx.reshape(-1)[0]  # a heavy row
    flat = idx.reshape(-1)
    flat[3], flat[11], flat[-2] = -1, n, 1 << 20
    w = (_round(r.rand(*shape) * 2.0 ** r.randint(-8, 8, shape), dtype)
         if weighted else None)
    return g, idx, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [None, 1, 3, 4])
def test_gather_backward_twin_matches_serial_loop(k, dtype):
    """Both forms of the twin bit for bit against the serial f32 loop: the
    sum order of CPU index_add_ is ascending f, the kernel's."""
    weighted = k is not None
    B, R, C, n = 2, 96, 12, 40
    g, idx, w = _inputs(3 + (k or 0), B, R, k or 1, C, n, dtype, weighted)
    want = _serial(g, idx, n, w, dtype)
    tdt = getattr(torch, dtype)
    got = tops.gather_backward_torch(
        torch.from_numpy(g).to(tdt), torch.from_numpy(idx), n,
        None if w is None else torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (B, n, C)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("B,n,R,k,C,dtype", [
    (2, 100, 30, 4, 24, "float32"),   # n, C unaligned; duplicate idx
    (1, 256, 171, 3, 3, "float32"),   # xyz-width rows, many duplicates
    (2, 100, 30, 4, 24, "bfloat16"),
])
def test_weighted_gather_backward_matches_pallas(B, n, R, k, C, dtype):
    """The weighted twin against gather_bwd_pallas (interpret mode) over
    JAX's products g[:, :, None] * w[..., None] in the same dtype, at
    test_gather_backward_torch_matches_pallas's bounds: f32 sums in another
    order, rtol 1e-5; bf16, both round the same f32 sums, one bf16 ulp."""
    r = np.random.RandomState(1)
    g = r.randn(B, R, C).astype(np.float32)
    idx = r.randint(0, n, (B, R, k)).astype(np.int32)
    w = r.rand(B, R, k).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    gw = (jnp.asarray(g).astype(jdt)[:, :, None, :]
          * jnp.asarray(w).astype(jdt)[..., None])
    want = pk.gather_bwd_pallas(gw, jnp.asarray(idx), n, interpret=True)
    assert want.dtype == jdt
    tg, tw = torch.from_numpy(g).to(tdt), torch.from_numpy(w).to(tdt)
    got = tops.gather_backward_torch(tg, torch.from_numpy(idx), n, tw)
    wrapped = tops.gather_backward(tg, torch.from_numpy(idx), n, tw)
    assert got.dtype == tdt and got.shape == (B, n, C)
    rtol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(wrapped.float().numpy(),
                                  got.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_form_equals_the_stacked_products(dtype):
    """The weighted form gives the bits of the unweighted form over the
    stacked products g[:, :, None] * w[..., None] (the backwards' former
    [B,R,k,C] stack), in f32 and bf16."""
    tdt = getattr(torch, dtype)
    g, idx, w = _inputs(5, 2, 64, 3, 16, 50, dtype, True)
    tg, tw = torch.from_numpy(g).to(tdt), torch.from_numpy(w).to(tdt)
    ti = torch.from_numpy(idx)
    stacked = tops.gather_backward_torch(tg[:, :, None, :] * tw[..., None],
                                         ti, 50)
    assert torch.equal(tops.gather_backward_torch(tg, ti, 50, tw), stacked)


def test_gather_backward_kernel_path_checks(monkeypatch):
    """The wrapper's kernel path (faked on the CPU): one launch per call in
    either form, the twin's result, and what the kernel does not take
    raises before a launch."""
    g, idx, w = _inputs(6, 2, 40, 4, 8, 30, "float32", True)
    tg, ti, tw = (torch.from_numpy(a) for a in (g, idx, w))
    want_w = tops.gather_backward_torch(tg, ti, 30, tw)
    want_u = tops.gather_backward_torch(tg[:, :, None].expand(-1, -1, 4, -1),
                                        ti, 30)
    fake = fake_kernels(monkeypatch)
    assert torch.equal(tops.gather_backward(tg, ti, 30, tw), want_w)
    assert torch.equal(tops.gather_backward(
        tg[:, :, None].expand(-1, -1, 4, -1), ti, 30), want_u)
    assert fake.gather_backward.launches == 2
    with pytest.raises(TypeError, match="g's dtype"):
        tops.gather_backward(tg, ti, 30, tw.double())
    with pytest.raises(ValueError, match=r"idx and weight \[B,R,k\]"):
        tops.gather_backward(tg, ti, 30, tw[:, :, :2])
    with pytest.raises(ValueError, match="does not match"):
        tops.gather_backward(tg, ti, 30)
    with pytest.raises(TypeError, match="int32"):
        tops.gather_backward(tg, ti.long(), 30, tw)
    assert fake.gather_backward.launches == 2


@pytest.mark.parametrize("B,n,C", [(24, 1024, 64), (24, 512, 128),
                                   (24, 256, 128), (24, 64, 256), (2, 100, 24),
                                   (1, 50000, 3)])
def test_gather_rows_per_block_fills_the_card(B, n, C):
    """About six blocks a multiprocessor of the H100 (132) where the shape
    has them, at most the kernel's 128 rows and 512 buckets a block, every
    row covered."""
    rpb = ck._gather_rows_per_block(B, n, C, 132, 128, 512)
    assert 1 <= rpb <= min(128, n) and -(-n // rpb) <= 512
    blocks = B * -(-n // rpb) * -(-C // 32)
    assert blocks >= min(6 * 132, B * -(-n // 128) * -(-C // 32)) // 2


def test_train_config_defaults_match_jax():
    """Every field the two TrainConfigs share has the same default (the
    port's model default was fusion_cls until config 2 was ported)."""
    from mm3d_tpu.training.loop import TrainConfig as JaxConfig
    from mm3d_tpu_torch.training.loop import TrainConfig

    ours = {f.name for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxConfig)}
    shared = sorted(ours & theirs)
    assert "model" in shared and len(shared) >= 25
    for name in shared:
        assert getattr(TrainConfig(), name) == getattr(JaxConfig(), name), name
