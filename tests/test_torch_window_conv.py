"""The window convolution's plain version against the JAX package, on the CPU.

``window_conv_ref`` (det3d_tpu_torch/ops/sparse.py), the twin of the CUDA
kernel csrc/window_conv.cu, is held against the JAX package's
``sparse.apply_conv_window`` and against its Pallas kernel
``band_conv.band_window_conv`` run in interpret mode (the JAX package's own
CPU route), on rulebooks of a small (5, 24, 24) grid: submanifold
(``center_shift=True``) and strided (``center_shift=False``), including
rulebooks whose last rows have present taps, and all-absent ones. fp32 on
both sides; the sums run in other orders, so rtol = 0, atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from det3d_tpu.ops import sparse as jsp
from det3d_tpu.ops import sparse_host as jsph
from det3d_tpu.ops.band_conv import band_window_conv
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.ops import sparse_host as sph
from det3d_tpu_torch.ops.window_conv_cuda import window_conv, window_conv_ref

torch.set_num_threads(2)

SHAPE = (5, 24, 24)
TOL = dict(rtol=0, atol=1e-5)


def _coords(r, v=96, actives=70):
    """(v, 3) zyx coords of ``actives`` voxels in rank order, -1 padded."""
    d, h, w = SHAPE
    cols = np.sort(r.choice(h * w, size=actives, replace=False))
    co = np.stack([r.randint(0, 3, size=actives), cols // w, cols % w],
                  1).astype(np.int32)
    co = np.concatenate([co, np.full((v - actives, 3), -1, np.int32)])
    return co[sph.rank_order(co, SHAPE)]


def subm_plan(seed, b=2):
    """(B, V, 9) packed submanifold rulebooks from the port's host builder."""
    r = np.random.RandomState(seed)
    return np.stack([sph.subm_windows(_coords(r), SHAPE, 3)
                     for _ in range(b)])


def down_plan(seed, b=2, cap=64):
    """(B, cap, 9) packed strided rulebooks (kernel 3, stride 2, pad 1)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(b):
        co = _coords(r)
        oc, _ = sph.transition(co, SHAPE, 3, 2, 1, cap)
        out.append(sph.down_windows(oc, co, SHAPE, 3, 2, 1))
    return np.stack(out)


def unpack(packed):
    r0, pres = sp.unpack_windows(torch.from_numpy(packed), 3)
    return r0, pres


def jax_refs(x, packed, w, center_shift):
    """apply_conv_window and the interpret-mode band kernel, as numpy."""
    r0 = jnp.asarray(packed & 0xFFFFFF)
    pres = jnp.stack([jnp.asarray((packed >> (24 + j)) & 1).astype(bool)
                      for j in range(3)], -1)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    plain = np.asarray(jsp.apply_conv_window(xj, r0, pres, wj, center_shift))
    band = np.asarray(band_window_conv(xj, r0, pres, wj, band=128,
                                       block_rows=32,
                                       center_shift=center_shift,
                                       interpret=True))
    return plain, band


@pytest.mark.parametrize("center_shift,cin,cout", [
    (True, 4, 16), (True, 16, 16), (False, 16, 32), (False, 8, 8)])
def test_matches_jax(center_shift, cin, cout):
    packed = subm_plan(1) if center_shift else down_plan(2)
    b, o, _ = packed.shape
    v = 96
    r = np.random.RandomState(cin + cout)
    x = r.randn(b, v, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.2).astype(np.float32)
    assert (packed >> 24).any(), "rulebook with no present tap"
    plain, band = jax_refs(x, packed, w, center_shift)
    r0, pres = unpack(packed)
    out = window_conv_ref(torch.from_numpy(x), r0, pres, torch.from_numpy(w),
                          center_shift)
    assert out.dtype == torch.float32 and out.shape == (b, o, cout)
    np.testing.assert_allclose(out.numpy(), plain, **TOL)
    np.testing.assert_allclose(out.numpy(), band, **TOL)
    # the wrapper on CPU tensors is the plain version on the packed words
    disp = window_conv(torch.from_numpy(x), torch.from_numpy(packed),
                       torch.from_numpy(w), center_shift)
    np.testing.assert_array_equal(disp.numpy(), out.numpy())


@pytest.mark.parametrize("center_shift", [True, False])
def test_windows_at_the_end_of_the_rows(center_shift):
    """Present taps on the last rows: windows clamp at V-1 and read zero
    past V; a window starting past V (r0 > V-1) clamps too."""
    b, v, cin, cout = 1, 12, 8, 8
    r = np.random.RandomState(5)
    packed = np.zeros((b, v, 9), np.int32)
    for o in range(v - 4, v):
        for k in range(9):
            r0 = min(o + k - 4, v + 2) if k != 4 else max(o - 1, 0)
            bits = r.randint(1, 8)
            packed[0, o, k] = max(r0, 0) | (bits << 24)
    x = r.randn(b, v, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.2).astype(np.float32)
    plain, _ = jax_refs(x, packed, w, center_shift)
    out = window_conv(torch.from_numpy(x), torch.from_numpy(packed),
                      torch.from_numpy(w), center_shift)
    np.testing.assert_allclose(out.numpy(), plain, **TOL)
    assert np.abs(plain[0, -4:]).max() > 0.1


@pytest.mark.parametrize("center_shift", [True, False])
def test_all_absent_gives_zeros(center_shift):
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 8).astype(
        np.float32))
    w = torch.ones(27, 8, 16)
    out = window_conv(x, torch.zeros(2, 64, 9, dtype=torch.int32), w,
                      center_shift)
    assert torch.equal(out, torch.zeros(2, 64, 16))


def test_bf16_operands_sum_in_fp32():
    """bf16 features and weights: products and sums in fp32, so the result
    is the fp32 conv of the bf16-rounded operands (no bf16 output)."""
    packed = torch.from_numpy(subm_plan(3))
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.randn(2, 96, 16).astype(np.float32))
    w = torch.from_numpy((r.randn(27, 16, 32) * 0.2).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    out = window_conv(xb, packed, wb, True)
    ref = window_conv(xb.float(), packed, wb.float(), True)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor the card raises; it never takes the
    plain version quietly."""
    x = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        window_conv(x, torch.zeros(1, 8, 9, dtype=torch.int32,
                                   device="meta"),
                    torch.zeros(27, 4, 16, device="meta"), True)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_rulebooks_equal_jax_host(seed):
    """The port's host window builders, native and numpy, give the JAX
    package's arrays."""
    r = np.random.RandomState(seed)
    co = _coords(r)
    jsubm = jsph.subm_windows(co, SHAPE, 3)
    np.testing.assert_array_equal(sph.subm_windows(co, SHAPE, 3), jsubm)
    np.testing.assert_array_equal(sph.subm_windows_ref(co, SHAPE, 3), jsubm)
    lk = sph.host_bitmap(sph.yxz_keys(co, SHAPE), SHAPE)
    jlk = jsph.host_bitmap(jsph.yxz_keys(co, SHAPE), SHAPE)
    oc, osh = sph.transition(co, SHAPE, 3, 2, 1, 64)
    joc, josh = jsph.transition(co, SHAPE, 3, 2, 1, 64)
    assert osh == josh == sph.transition_ref(co, SHAPE, 3, 2, 1, 64)[1]
    np.testing.assert_array_equal(oc, joc)
    np.testing.assert_array_equal(
        sph.transition_ref(co, SHAPE, 3, 2, 1, 64)[0], joc)
    jdown = jsph.down_windows(oc, jlk, SHAPE, 3, 2, 1)
    np.testing.assert_array_equal(sph.down_windows(oc, co, SHAPE, 3, 2, 1),
                                  jdown)
    np.testing.assert_array_equal(
        sph.down_windows_ref(oc, lk, SHAPE, 3, 2, 1), jdown)


def test_to_dense_drops_padding_rows():
    feats = torch.arange(12, dtype=torch.float32).view(1, 4, 3)
    co = torch.tensor([[[0, 1, 2], [-1, -1, -1], [1, 0, 0], [-1, -1, -1]]],
                      dtype=torch.int32)
    dense = sp.to_dense(feats, co, (2, 2, 3))
    assert dense.shape == (1, 2, 2, 3, 3)
    assert torch.equal(dense[0, 0, 1, 2], feats[0, 0])
    assert torch.equal(dense[0, 1, 0, 0], feats[0, 2])
    assert float(dense.abs().sum()) == float(feats[0, [0, 2]].sum())
    lin = sp.linearize(co, (2, 2, 3))
    assert torch.equal(sp.delinearize(lin, (2, 2, 3)), co)
