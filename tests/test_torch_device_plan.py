"""The device rulebook builders and voxelizers (the JAX package's
``plan=None`` path) against the JAX functions they copy, on the CPU.

- ``popcount32`` (SWAR on int64-held words) against ``np.bitwise_count``
  on edge words;
- each builder of ops/sparse.py, from ``yxz_order`` through
  ``conv_out_coords`` and ``pack_windows``, array-equal to JAX's on seeded
  voxel sets: a small grid at depth 12 and at depth 41 (two words a
  column), and SECOND's full grid (41, 1600, 1408) with ~2000 voxels;
- models/backbones.py::build_plan_device array-equal to the port's host
  plan (``host_plan_fn``) and to JAX's ``build_plan_device``, with cap
  overflow and an empty scan. JAX's evaluation plan keeps the rows of a
  stage without a subm rulebook (the dense tail's transition, the sparse
  z conv) in conv_out_coords' zyx order where the host plan, JAX's
  training plan and the port use rank order: there the rows are held
  equal as a set, row by row with their down rulebooks;
- the device voxelizer's yxz buffer and fused mean (yxz and hashed
  order) against JAX's: coords, counts and num_voxels equal, means within
  rtol = atol = 1e-5, and equal to the host voxelizer's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.core.voxelize import VoxelGenerator as JVoxelGenerator
from det3d_tpu.models import backbones as jbb
from det3d_tpu.ops import sparse as jsp
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_second import second_config

torch.set_num_threads(2)

SMALL = (12, 40, 36)
DEEP = (41, 40, 36)
SECOND_GRID = (41, 1600, 1408)
MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
PC = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VG_KW = dict(voxel_size=(0.05, 0.05, 0.1), point_cloud_range=PC,
             max_num_points=5)


def voxel_sets(shape, counts, cap, seed, clusters=12):
    """(B, cap, 3) int32 zyx of distinct voxels in clusters, in random row
    order, -1 rows padding each sample's ``counts[i]`` voxels."""
    r = np.random.RandomState(seed)
    d, h, w = shape
    out = np.full((len(counts), cap, 3), -1, np.int32)
    for i, n in enumerate(counts):
        centers = r.randint(0, [d, h, w], size=(clusters, 3))
        cells = set()
        while len(cells) < n:
            c = centers[r.randint(clusters)] + r.randint(-3, 4, size=3)
            if (c >= 0).all() and (c < shape).all():
                cells.add(tuple(int(v) for v in c))
        co = np.asarray(sorted(cells), np.int32).reshape(-1, 3)
        out[i, :n] = co[r.permutation(n)]
    return out


def ranked(coords, shape):
    """The rows in rank (yxz) order, as JAX orders them."""
    order = np.asarray(jax.vmap(lambda c: jsp.yxz_order(c, shape))(
        jnp.asarray(coords)))
    return np.take_along_axis(coords, order[..., None], axis=1)


def jbitmap(coords, shape):
    return np.asarray(jsp.build_bitmap_batch(jnp.asarray(coords), shape))


def tbitmap(coords, shape):
    return sp.build_bitmap_batch(torch.from_numpy(coords), shape)


def as_words(jtable):
    """JAX's int32 table as the port holds it: words as uint32 values."""
    return jtable.astype(np.int64) & 0xFFFFFFFF


CASES = {"small": (SMALL, (300, 120), 320), "deep": (DEEP, (500, 0), 512),
         "second": (SECOND_GRID, (2000, 1500), 2048)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    shape, counts, cap = CASES[request.param]
    co = voxel_sets(shape, counts, cap, seed=7)
    return shape, co, ranked(co, shape)


# ---------------------------------------------------------------------------
# popcount, order, bitmap, fetch
# ---------------------------------------------------------------------------

def test_popcount32_matches_bitwise_count():
    edge = [0, 1, 2, 3, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFFFFFFE,
            0x55555555, 0xAAAAAAAA, 0x0F0F0F0F, 0xF0F0F0F0, 0x01010101,
            0x80000001, 0x00FF00FF, 0xFF00FF00]
    rnd = np.random.RandomState(0).randint(0, 2 ** 32, 4096, dtype=np.int64)
    words = np.concatenate([np.asarray(edge, np.int64), rnd,
                            np.int64(1) << np.arange(32)])
    got = sp.popcount32(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(
        got, np.bitwise_count(words.astype(np.uint32)).astype(np.int64))
    table = np.asarray([bin(i).count("1") for i in range(256)])
    by_bytes = sum(table[(words >> s) & 0xFF] for s in (0, 8, 16, 24))
    np.testing.assert_array_equal(got, by_bytes)


def test_yxz_order_and_lin_equal_jax(case):
    shape, co, _ = case
    ref = np.asarray(jax.vmap(lambda c: jsp.yxz_order(c, shape))(
        jnp.asarray(co)))
    np.testing.assert_array_equal(
        sp.yxz_order(torch.from_numpy(co), shape).numpy(), ref)
    lin = np.asarray(jax.vmap(lambda c: jsp.yxz_lin(c, shape))(
        jnp.asarray(co)))
    np.testing.assert_array_equal(
        sp.yxz_lin(torch.from_numpy(co), shape).numpy(), lin)


def test_bitmap_equals_jax(case):
    shape, _, rk = case
    ref = jbitmap(rk, shape)
    got = tbitmap(rk, shape).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, as_words(ref))


def test_bitmap_fetch_equals_jax_with_clip(case):
    """Column queries at both ends of the grid and past them: the port
    clamps a slice start as XLA's CLIP gather does."""
    shape, _, rk = case
    d, h, w = shape
    ref_t = jbitmap(rk, shape)
    r = np.random.RandomState(1)
    flat = np.concatenate([[0, 1, h * w - 1, h * w, h * w + 2, -3],
                           r.randint(0, h * w, 200)]).astype(np.int32)
    flat = np.stack([flat, flat[::-1]])
    rb, rlo, rhi = jsp._bitmap_fetch(jnp.asarray(ref_t), jnp.asarray(flat), d)
    base, lo, hi = sp._bitmap_fetch(torch.from_numpy(as_words(ref_t)),
                                    torch.from_numpy(flat), d)
    np.testing.assert_array_equal(base.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    if d > 32:
        np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    else:
        assert hi is None


@pytest.mark.parametrize("d", [12, 32, 33, 41, 64])
def test_windows_from_words_equal_jax(d):
    r = np.random.RandomState(d)
    n = 3000
    lo = r.randint(0, 2 ** 32, n, dtype=np.int64)
    lo[:8] = [0, 0xFFFFFFFF, 1, 0x80000000, 0x7FFFFFFF, 0, 5, 0xF0000000]
    hi = (r.randint(0, 2 ** (d - 32), n, dtype=np.int64) if d > 32
          else np.zeros(n, np.int64))
    base = r.randint(0, 1 << 20, n).astype(np.int32)
    okc = r.uniform(size=n) < 0.9
    z0 = r.randint(-3, d + 2, n).astype(np.int32)
    rr0, rpres = jsp._windows_from_words(
        jnp.asarray(base), jnp.asarray(lo.astype(np.uint32)),
        jnp.asarray(hi.astype(np.uint32)), jnp.asarray(okc),
        jnp.asarray(z0), 3, d)
    r0, pres = sp._windows_from_words(
        torch.from_numpy(base).long(), torch.from_numpy(lo),
        torch.from_numpy(hi) if d > 32 else None, torch.from_numpy(okc),
        torch.from_numpy(z0).long(), 3, d)
    np.testing.assert_array_equal(r0.numpy(), np.asarray(rr0))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rpres))


# ---------------------------------------------------------------------------
# window rulebooks, candidates, output coords, packing, stage lookup
# ---------------------------------------------------------------------------

def test_subm_window_rulebook_equals_jax(case):
    shape, _, rk = case
    jt = jbitmap(rk, shape)
    rr0, rpres = jsp.subm_window_rulebook_batch(
        jnp.asarray(rk), shape, 3, ("bitmap", jnp.asarray(jt)))
    r0, pres = sp.subm_window_rulebook_batch(
        torch.from_numpy(rk), shape, 3, tbitmap(rk, shape))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rpres))
    np.testing.assert_array_equal(r0.numpy(), np.asarray(rr0))
    assert pres.numpy()[..., 4, :].sum() > pres.shape[1] // 2
    packed = sp.pack_windows(r0, pres).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jsp.pack_windows(rr0, rpres)))
    assert packed.dtype == np.int32


@pytest.mark.parametrize("geom", [(3, 2, 1), (3, 2, (0, 1, 1)),
                                  ((3, 1, 1), (2, 1, 1), 0)])
def test_down_rulebook_and_out_coords_equal_jax(case, geom):
    shape, co, rk = case
    k, s, p = geom
    oshape = sp.out_spatial_shape(shape, k, s, p)
    # candidates, per sample
    jc = jax.vmap(lambda c: jsp._down_candidates(c, shape, k, s, p, oshape)[
        :4])(jnp.asarray(co))
    tc = sp._down_candidates(torch.from_numpy(co), k, s, p, oshape)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(
            np.broadcast_to(a.numpy(), jc[3].shape),
            np.broadcast_to(np.asarray(b), jc[3].shape))
    # output coords with room and under overflow (the low-z prefix)
    for max_out in (97, co.shape[1]):
        ref, _ = jax.vmap(lambda c: jsp.conv_out_coords(
            c, shape, k, s, p, max_out))(jnp.asarray(co))
        out, out_shape = sp.conv_out_coords(torch.from_numpy(co), shape,
                                            k, s, p, max_out)
        assert tuple(out_shape) == tuple(oshape)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref)[..., 0] >= 0).sum(axis=1).max() > 97  # overflow
    # the down rulebook over the input bitmap, for rank-ordered outputs
    out_rk = ranked(np.asarray(ref), oshape)
    jt = jbitmap(rk, shape)
    rr0, rpres = jsp.conv_window_rulebook_batch(
        shape, jnp.asarray(out_rk), k, s, p, ("bitmap", jnp.asarray(jt)))
    r0, pres = sp.conv_window_rulebook_batch(
        shape, torch.from_numpy(out_rk), k, s, p, tbitmap(rk, shape))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rpres))
    np.testing.assert_array_equal(r0.numpy(), np.asarray(rr0))
    np.testing.assert_array_equal(
        sp.pack_windows(r0, pres).numpy(),
        np.asarray(jsp.pack_windows(rr0, rpres)))


def test_stage_lookup_equals_jax(case):
    shape, co, _ = case
    ro, rco, (kind, rt) = jsp.stage_lookup_batch(jnp.asarray(co), shape)
    order, tco, table = sp.stage_lookup_batch(torch.from_numpy(co), shape)
    assert kind == "bitmap"
    np.testing.assert_array_equal(order.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(tco.numpy(), np.asarray(rco))
    np.testing.assert_array_equal(table.numpy(), as_words(np.asarray(rt)))


def test_deep_grid_raises_with_the_roadmap_item():
    """Deep grids are ported (tests/test_torch_deep_grid.py): the device
    lookup takes a depth of 65 through the dense table, while the bitmap
    and every host plan still refuse it, as the JAX package's
    middle_plan_spec asserts."""
    co = torch.zeros((1, 4, 3), dtype=torch.int32)
    _, _, lookup = sp.stage_lookup_batch(co, (65, 8, 8))
    assert lookup[0] == "dense" and lookup[1].shape == (1, 65 * 8 * 8)
    with pytest.raises(ValueError, match="depths 1 to 64"):
        sp.build_bitmap_batch(co, (65, 8, 8))
    with pytest.raises(ValueError, match="host plan"):
        bb.middle_plan_spec(dict(), (8, 8, 64), 16)
    assert bb.middle_plan_spec(dict(), (8, 8, 64), 16,
                               host=False)["shape0"] == (65, 8, 8)


# ---------------------------------------------------------------------------
# whole plans
# ---------------------------------------------------------------------------

def spec_of(order, dense_tail, dense_from, max_voxels, grid):
    return bb.middle_plan_spec(
        dict(stage_caps=(1.0, 0.9, 0.8, 0.7), dense_tail=dense_tail,
             dense_from=dense_from, pre_ranked=order == "yxz"),
        grid, max_voxels)


def last_stage_rows(plan, i):
    """Stage ``i``'s rows as a set: (co, down) rows sorted by co."""
    co, down = np.asarray(plan[f"co{i}"]), np.asarray(plan[f"down{i}"])
    o = np.argsort(co, axis=1, kind="stable")
    return (np.take_along_axis(co, o, 1),
            np.take_along_axis(down, o[..., None], 1))


@pytest.mark.parametrize("order,dense_tail,dense_from", [
    ("yxz", True, 3), ("hashed", False, 3), ("hashed", True, 2),
    ("yxz", True, 1)])
@pytest.mark.parametrize("points,max_voxels,empty", [
    (3000, 512, False), (4000, 160, True)])
def test_plan_device_equals_host_and_jax(order, dense_tail, dense_from,
                                         points, max_voxels, empty):
    """The second row: 160 voxels overflow the cap (and every stage's),
    and the second scan is empty."""
    b = structured_batch(2, points, PC, seed=5)
    if empty:
        b["num_points"][1] = 0
    vg = VoxelGenerator(order=order, fuse_mean=True, max_voxels=max_voxels,
                        **VG_KW)
    spec = spec_of(order, dense_tail, dense_from, max_voxels, vg.grid_size)
    host = sph_plan(b, vg, spec)
    vox = vg.generate_batch(torch.from_numpy(b["points"]),
                            torch.from_numpy(b["num_points"]))
    if empty:
        assert vox["num_voxels"].tolist() == [max_voxels, 0]
    dev = {k: v.numpy() for k, v in
           bb.build_plan_device(vox["coords"], spec).items()}
    assert sorted(dev) == sorted(k[5:] for k in host if k.startswith("plan_"))
    for k, v in dev.items():
        assert v.dtype == np.int32, k
        np.testing.assert_array_equal(v, host[f"plan_{k}"], err_msg=k)
    if empty:
        assert (dev["s0"][1] == 0).all() and (dev["co1"][1] == 2**31 - 1).all()

    jco = jnp.asarray(vox["coords"].numpy())
    train = jax.jit(lambda c: jbb.build_plan_device(c, spec, True))(jco)
    for k, v in dev.items():
        np.testing.assert_array_equal(v, np.asarray(train[k]), err_msg=k)
    evl = jax.jit(lambda c: jbb.build_plan_device(c, spec, False))(jco)
    assert sorted(evl) == sorted(dev)
    last = len(spec["stages"])
    for k, v in dev.items():
        if k not in (f"co{last}", f"down{last}"):
            np.testing.assert_array_equal(v, np.asarray(evl[k]), err_msg=k)
    for a, r in zip(last_stage_rows(dev, last), last_stage_rows(evl, last)):
        np.testing.assert_array_equal(a, r)


def sph_plan(b, vg, spec):
    from det3d_tpu_torch.ops import sparse_host as sph
    kw = dict(voxel_size=vg.voxel_size, pc_range=vg.point_cloud_range,
              grid_size=vg.grid_size, max_voxels=vg.max_voxels,
              order=vg.effective_order, spec=spec)
    plans = [sph.build_plan(b["points"][i], b["num_points"][i], **kw)
             for i in range(b["points"].shape[0])]
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


def test_plan_device_equals_host_plan_fn_second():
    """The cut SECOND config through build_stack: host_plan_fn's plan and
    voxels against the device voxelizer and build_plan_device."""
    model, vg, _, _, _ = build_stack(second_config(), device="cpu")
    b = structured_batch(2, 3000, PC, seed=3)
    host = host_plan_fn(model, vg, voxelize=True)(b["points"],
                                                  b["num_points"])
    vox = vg.generate_batch(torch.from_numpy(b["points"]),
                            torch.from_numpy(b["num_points"]))
    for k, hk in (("coords", "coordinates"),
                  ("num_points_per_voxel", "num_points_per_voxel"),
                  ("num_voxels", "num_voxels")):
        np.testing.assert_array_equal(vox[k].numpy(), host[hk], err_msg=k)
    np.testing.assert_allclose(vox["voxels"].numpy(), host["voxels"],
                               **MEAN_TOL)
    spec = bb.middle_plan_spec(model.backbone, vg.grid_size, vg.max_voxels)
    dev = bb.build_plan_device(vox["coords"], spec)
    for k, v in dev.items():
        np.testing.assert_array_equal(v.numpy(), host[f"plan_{k}"],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# device voxelizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,fuse_mean", [("yxz", False), ("yxz", True),
                                             ("hashed", True),
                                             ("appearance", True)])
@pytest.mark.parametrize("max_voxels", [600, 150])
def test_device_voxelizer_equals_jax(order, fuse_mean, max_voxels):
    """The yxz buffer and the fused mean against JAX's device voxelizer;
    150 voxels overflow the cap; the second scan is cut short."""
    b = structured_batch(2, 3000, PC, seed=9)
    b["num_points"][1] = 1700
    kw = dict(VG_KW, max_voxels=max_voxels, order=order, fuse_mean=fuse_mean)
    ref = JVoxelGenerator(**kw).generate_batch(jnp.asarray(b["points"]),
                                               jnp.asarray(b["num_points"]))
    vg = VoxelGenerator(**kw)
    out = vg.generate_batch(torch.from_numpy(b["points"]),
                            torch.from_numpy(b["num_points"]))
    for k in ("coords", "num_points_per_voxel", "num_voxels"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
        assert out[k].dtype == torch.int32
    assert out["voxels"].shape == ref["voxels"].shape
    np.testing.assert_allclose(out["voxels"].numpy(),
                               np.asarray(ref["voxels"]), **MEAN_TOL)
    if max_voxels == 150:
        assert (out["num_voxels"] == 150).all()
    from det3d_tpu_torch.ops.voxelize_host import host_voxelize
    host = host_voxelize(b["points"][1], b["num_points"][1],
                         **vg.host_kwargs())
    np.testing.assert_array_equal(out["coords"][1].numpy(), host["coords"])
    np.testing.assert_allclose(out["voxels"][1].numpy(), host["voxels"],
                               **MEAN_TOL)


@pytest.mark.parametrize("shape", [(1, 7), (3, 1), (4, 1000), (2, 0)])
def test_row_cumsum_equals_cumsum(shape):
    from det3d_tpu_torch.core.voxelize import row_cumsum
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 2 ** 20, shape, dtype=np.int64))
    assert torch.equal(row_cumsum(x), torch.cumsum(x, dim=1))
