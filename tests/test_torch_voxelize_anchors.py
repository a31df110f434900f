"""The port's voxelizer and anchors against the JAX package, on the CPU.

Voxelizer outputs must be exactly equal: both sides quantize with the same
fp32 operations, sort by the same keys and only move data. Anchors are the
same numpy code and must be equal too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from det3d_tpu.core.anchors import AnchorGeneratorRange as JAnchorGen
from det3d_tpu.core.anchors import GroundBox3dCoder as JCoder
from det3d_tpu.core.target import TargetAssigner as JAssigner
from det3d_tpu.core.voxelize import VoxelGenerator as JVoxelGenerator
from det3d_tpu.ops.voxelize_host import host_voxelize_batch
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.core.anchors import build_box_coder
from det3d_tpu_torch.core.target import build_target_assigners
from det3d_tpu_torch.core.voxelize import VoxelGenerator, mix32

torch.set_num_threads(2)

VG_KW = dict(voxel_size=[0.1, 0.1, 0.2],
             point_cloud_range=[0, -4.0, -1.0, 7.2, 4.0, 1.2],
             max_num_points=5)
KEYS = ("voxels", "coords", "num_points_per_voxel", "num_voxels")


def _clouds(seed, b=2, p=900):
    """Points spread past the range (out-of-range rows) with padded rows."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform([0, -4.4, -1.2, 0], [8.0, 4.4, 1.4, 1.0],
                      size=(b, p, 4)).astype(np.float32)
    # a dense cluster, so voxels overflow max_num_points
    pts[:, :100, :3] = rng.normal([3.0, 0.0, 0.1], 0.03, (b, 100, 3))
    n = np.asarray([p, p // 3], np.int32)[:b]
    return pts, n


@pytest.mark.parametrize("max_voxels", [600, 64])      # fits / overflows
def test_voxelizer_equals_jax(max_voxels):
    pts, n = _clouds(0)
    jvg = JVoxelGenerator(order="hashed", max_voxels=max_voxels, **VG_KW)
    ref = jvg.generate_batch(jnp.asarray(pts), jnp.asarray(n))
    tvg = VoxelGenerator(order="hashed", max_voxels=max_voxels, **VG_KW)
    out = tvg.generate_batch(torch.from_numpy(pts), torch.from_numpy(n))
    for k in KEYS:
        assert out[k].dtype == torch.int32 or k == "voxels", k
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    nv = out["num_voxels"].numpy()
    assert nv[0] == max_voxels if max_voxels == 64 else nv[0] < max_voxels
    assert (out["num_points_per_voxel"].numpy() == 5).any()  # point cap hit
    assert (out["coords"].numpy()[1, nv[1]:] == -1).all()    # padded rows


def test_voxelizer_equals_host_twin_on_structured_scans():
    """The flagship-like structured scans, checked against the host twin
    (itself bit-exact with the JAX voxelizer)."""
    from det3d_tpu.utils.synth import structured_batch
    pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
    b = structured_batch(2, 3000, pc, seed=3)
    tvg = VoxelGenerator(voxel_size=(0.2, 0.2, 4.0), point_cloud_range=pc,
                         max_num_points=8, max_voxels=700)
    out = tvg.generate_batch(torch.from_numpy(b["points"]),
                             torch.from_numpy(b["num_points"]))
    jvg = JVoxelGenerator(voxel_size=(0.2, 0.2, 4.0), point_cloud_range=pc,
                          max_num_points=8, max_voxels=700, order="hashed")
    host = host_voxelize_batch(b["points"], b["num_points"], jvg)
    for k, hk in zip(KEYS, ("voxels", "coordinates", "num_points_per_voxel",
                            "num_voxels")):
        np.testing.assert_array_equal(out[k].numpy(), host[hk], err_msg=k)


def test_empty_cloud_and_unported_orders():
    tvg = VoxelGenerator(order="hashed", max_voxels=32, **VG_KW)
    pts, _ = _clouds(1)
    out = tvg.generate_batch(torch.from_numpy(pts),
                             torch.tensor([0, 0], dtype=torch.int32))
    assert out["num_voxels"].tolist() == [0, 0]
    assert not out["voxels"].any() and (out["coords"] == -1).all()
    # yxz and the fused mean (SECOND's and CBGS's orders) run on the
    # device too, as JAX's device voxelizer runs them
    n = np.asarray([5, 0], np.int32)
    for kw in (dict(order="yxz"), dict(order="hashed", fuse_mean=True)):
        vg = VoxelGenerator(**kw, **VG_KW)
        out = vg.generate_batch(torch.from_numpy(pts), torch.from_numpy(n))
        ref = JVoxelGenerator(**kw, **VG_KW).generate_batch(
            jnp.asarray(pts), jnp.asarray(n))
        for k in KEYS:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                          err_msg=k)
        assert out["num_voxels"].tolist()[1] == 0


def test_mix32_matches_uint32_reference():
    x = np.random.RandomState(2).randint(0, 2 ** 31 - 1, 10000,
                                         dtype=np.int64)
    u = x.astype(np.uint32)
    u = u ^ (u >> np.uint32(16))
    u = u * np.uint32(0x85EBCA6B)
    u = u ^ (u >> np.uint32(13))
    u = u * np.uint32(0xC2B2AE35)
    u = u ^ (u >> np.uint32(16))
    np.testing.assert_array_equal(mix32(torch.from_numpy(x)).numpy(),
                                  u.astype(np.int64))


@pytest.mark.parametrize("small", [True, False])
def test_anchors_equal_jax_target_assigner(small):
    """The flagship anchors: 2 per location, (fz, fy, fx, loc) order."""
    cfg = flagship_config(small=small)
    acfg = cfg["assigner"]
    tasg = build_target_assigners(acfg["target_assigner"],
                                  build_box_coder(acfg["box_coder"]),
                                  cfg["tasks"])[0]
    g = acfg["target_assigner"]["anchor_generators"][0]
    jasg = JAssigner(box_coder=JCoder(), anchor_generators=[JAnchorGen(
        anchor_ranges=g["anchor_ranges"], sizes=g["sizes"],
        rotations=g["rotations"], match_threshold=0.6,
        unmatch_threshold=0.45, class_name="Car")])
    grid = VoxelGenerator(voxel_size=cfg["voxel_generator"]["voxel_size"],
                          point_cloud_range=cfg["voxel_generator"]["range"],
                          max_num_points=32).grid_size
    osf = acfg["out_size_factor"]
    fm = [1, grid[1] // osf, grid[0] // osf]
    jasg.generate_anchors(fm)
    tasg.generate_anchors(fm)
    np.testing.assert_array_equal(tasg.anchors_flat, jasg.anchors_flat)
    if not small:
        assert tasg.anchors_flat.shape == (248 * 216 * 2, 7)     # 107136
    np.testing.assert_array_equal(tasg.anchors_on("cpu").numpy(),
                                  jasg.anchors_flat)
