"""The port's native host plan and host voxelizer (csrc/hostplan.cc) against
its numpy plain versions and the JAX package's builders: raw equality,
every key and every dtype.

The JAX package's ``build_plan`` / ``host_voxelize`` run twice, once with
its own native path as it stands (``_hp()``) and once with ``_hp``
monkeypatched to None (its numpy twins), as tests/test_host_plan_native.py
does. The port's ``*_ref`` functions are its numpy plain versions.
"""

import copy
import os

import numpy as np
import pytest

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.ops import sparse_host as jsph
from det3d_tpu.ops import voxelize_host as jvh
from det3d_tpu_torch import csrc
from det3d_tpu_torch.apis.train import (build_stack, host_plan_fn,
                                        host_plan_ref_fn)
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models.backbones import middle_plan_spec
from det3d_tpu_torch.ops import sparse_host as sph
from det3d_tpu_torch.ops import voxelize_host as vh
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.synth import structured_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VG_KW = dict(voxel_size=[0.1, 0.1, 0.2],
             point_cloud_range=[0, -4.0, -1.0, 7.2, 4.0, 1.2],
             max_num_points=5, max_voxels=600)


def assert_same(ours, ref, what=""):
    """Equal keys, and per key equal dtype, shape and values."""
    assert sorted(ours) == sorted(ref), what
    for k in ref:
        o, r = np.asarray(ours[k]), np.asarray(ref[k])
        assert o.dtype == r.dtype, f"{what} {k}: {o.dtype} vs {r.dtype}"
        np.testing.assert_array_equal(o, r, err_msg=f"{what} {k}")


def jax_both(monkeypatch, fn):
    """fn() with the JAX package's native builders as they stand, then with
    its numpy twins."""
    native = fn()
    with monkeypatch.context() as m:
        m.setattr(jsph, "_hp", lambda: None)
        numpy = fn()
    return native, numpy


def cloud(npts, seed=42):
    """900 points, some out of range (sentinel rows); the first ``npts``
    are real."""
    r = np.random.RandomState(seed)
    pts = r.uniform([0, -4.4, -1.2, 0], [8.0, 4.4, 1.4, 1.0],
                    size=(900, 4)).astype(np.float32)
    return pts, npts


# ---------------------------------------------------------------------------
# the cut cases of tests/test_host_plan_native.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,pre_ranked", [("yxz", True),
                                              ("hashed", False)])
@pytest.mark.parametrize("npts", [0, 300, 900])
def test_plan_equals_numpy_and_jax(monkeypatch, order, pre_ranked, npts):
    """0, 300 and 900 points; the 900-point cloud saturates the 600-voxel
    cap."""
    vg = VoxelGenerator(order=order, fuse_mean=True, **VG_KW)
    pts, n = cloud(npts)
    spec = middle_plan_spec(dict(stage_caps=(1.0, 0.9, 0.8, 0.7),
                                 dense_tail=True, dense_from=3,
                                 pre_ranked=pre_ranked),
                            vg.grid_size, vg.max_voxels)
    kw = dict(voxel_size=tuple(vg.voxel_size),
              pc_range=tuple(vg.point_cloud_range), grid_size=vg.grid_size,
              max_voxels=vg.max_voxels, order=order, spec=spec)
    ours = sph.build_plan(pts, n, **kw)
    assert_same(ours, sph.build_plan_ref(pts, n, **kw), "numpy")
    for what, ref in zip(("jax native", "jax numpy"), jax_both(
            monkeypatch, lambda: jsph.build_plan(pts, n, train=False,
                                                 **kw))):
        assert_same(ours, ref, what)
    if npts == 900:
        assert (ours["plan_co1"] != sph.SENTINEL).all()
    for fuse_mean in (True, False):
        vkw = dict(voxel_size=kw["voxel_size"], pc_range=kw["pc_range"],
                   grid_size=vg.grid_size, max_voxels=vg.max_voxels,
                   max_points=5, order=order, fuse_mean=fuse_mean)
        v = vh.host_voxelize(pts, n, **vkw)
        assert_same(v, vh.host_voxelize_ref(pts, n, **vkw), "numpy")
        for what, ref in zip(("jax native", "jax numpy"), jax_both(
                monkeypatch, lambda: jvh.host_voxelize(pts, n, **vkw))):
            assert_same(v, ref, what)
        # the plan's ids and order give the same voxels without resorting
        assert_same(vh.host_voxelize(pts, n, lin=ours["point_lin"],
                                     perm=ours["point_perm"], **vkw), v)


@pytest.mark.parametrize("order", ["hashed", "yxz"])
def test_point_order_hash_ties_and_sentinels(monkeypatch, order):
    """Duplicate ids keep their input order and the sentinel rows sort
    last, as the stable lexsort has it; voxel coords skip the sentinels."""
    lin = np.asarray([7, 3, 7, sph.SENTINEL, 3, 12, sph.SENTINEL, 0, 7],
                     np.int32)
    grid = (16, 16, 4)
    ours = sph.point_order(lin, grid, order)
    np.testing.assert_array_equal(ours, sph.point_order_ref(lin, grid, order))
    for ref in jax_both(monkeypatch,
                        lambda: jsph.point_order(lin, grid, order)):
        np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.int32
    assert list(ours[-2:]) == [3, 6]
    sevens = [int(i) for i in ours if lin[i] == 7]
    assert sevens == [0, 2, 8]
    co = sph.voxel_coords(lin, grid, 6, order)
    assert_same({"c": co}, {"c": sph.voxel_coords_ref(lin, grid, 6, order)})
    assert (co[4:] == -1).all() and (co[:4] >= 0).all()


def test_argsort_lin_duplicates_and_sentinels():
    r = np.random.RandomState(0)
    lin = r.randint(0, 40, size=5000).astype(np.int32)
    lin[r.rand(5000) < 0.1] = sph.SENTINEL
    out = sph.argsort_lin(lin)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, np.argsort(lin, kind="stable"))


@pytest.mark.parametrize("case", ["overflows", "fits", "empty"])
def test_appearance_voxelizer_equals_numpy_and_jax(monkeypatch, case):
    """First-come voxel order: the cap saturated in both voxels and points
    (many points a pillar), both caps held, and no point."""
    pts, n = cloud(900, seed=7)
    v_cap, t_cap = {"overflows": (40, 3), "fits": (2000, 64),
                    "empty": (40, 3)}[case]
    if case == "empty":
        n = 0
    vkw = dict(voxel_size=(0.8, 0.8, 2.6), pc_range=(0, -4.0, -1.0, 7.2, 4.0,
                                                     1.6),
               grid_size=(9, 10, 1), max_voxels=v_cap, max_points=t_cap,
               order="appearance", fuse_mean=False)
    ours = vh.host_voxelize(pts, n, **vkw)
    assert_same(ours, vh.host_voxelize_ref(pts, n, **vkw), "numpy")
    for what, ref in zip(("jax native", "jax numpy"), jax_both(
            monkeypatch, lambda: jvh.host_voxelize(pts, n, **vkw))):
        assert_same(ours, ref, what)
    nv, counts = int(ours["num_voxels"]), ours["num_points_per_voxel"]
    if case == "overflows":
        assert nv == v_cap and (counts == t_cap).all()
    elif case == "fits":
        assert 40 < nv < v_cap and 1 < counts.max() < t_cap
    else:
        assert nv == 0 and (ours["coords"] == -1).all()


# ---------------------------------------------------------------------------
# one full-size scan of each shipped config
# ---------------------------------------------------------------------------

def shipped(name):
    cfg = Config.fromfile(os.path.join(REPO, "configs", f"{name}.py"))
    return {k: copy.deepcopy(cfg[k]) for k in
            ("tasks", "model", "assigner", "test_cfg", "voxel_generator")}


# config: (points a scan, point features, its voxels the cap overflows)
FULL = {"kitti_car_second": (16384, 4, False),
        "kitti_all_second": (16384, 4, False),
        "nusc_cbgs_voxelnet": (300000, 5, True),
        "lyft_cbgs_voxelnet": (300000, 5, True),
        "nusc_pointpillars": (300000, 5, True)}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_size_scan_equals_numpy_and_jax(monkeypatch, name):
    """One scan as chip_smoke.py feeds the card (Lyft's 300000 points over
    +-100.8 m overflow its 80000-voxel cap): host_plan_fn's plans and
    voxels (nuScenes PointPillars: its appearance voxels alone) equal
    host_plan_ref_fn's and the JAX package's host_plan_fn's, native and
    numpy."""
    points, feats, overflows = FULL[name]
    c = shipped(name)
    model, vg = build_stack(c, device="cpu")[:2]
    jmodel, jvg = jbuild_stack(copy.deepcopy(c))[:2]
    scan = structured_batch(1, points, c["voxel_generator"]["range"], seed=3)
    if feats == 5:
        p = scan["points"]
        scan["points"] = np.concatenate([p, np.zeros_like(p[..., :1])], -1)
    args = (scan["points"], scan["num_points"])
    ours = host_plan_fn(model, vg, voxelize=True)(*args)
    assert_same(ours, host_plan_ref_fn(model, vg, voxelize=True)(*args),
                "numpy")
    for what, ref in zip(("jax native", "jax numpy"), jax_both(
            monkeypatch, lambda: jhost_plan_fn(jmodel, jvg, train=False,
                                               voxelize=True)(*args))):
        assert_same(ours, ref, what)
    lin = sph.point_lin(scan["points"][0], scan["num_points"][0],
                        vg.voxel_size, vg.point_cloud_range, vg.grid_size)
    occupied = len(np.unique(lin[lin != sph.SENTINEL]))
    assert (occupied > vg.max_voxels) == overflows
    assert int(ours["num_voxels"][0]) == min(occupied, vg.max_voxels)
    assert any(k.startswith("plan_") for k in ours) == (
        name != "nusc_pointpillars")


# ---------------------------------------------------------------------------
# the serving path reaches only the native builders; the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kitti_car_second", "nusc_pointpillars"])
def test_serving_path_never_reaches_numpy(monkeypatch, name):
    c = shipped(name)
    model, vg = build_stack(c, device="cpu")[:2]
    scan = structured_batch(2, 2000, c["voxel_generator"]["range"], seed=5)
    if c["model"]["reader"].get("num_input_features", 4) == 5:
        p = scan["points"]
        scan["points"] = np.concatenate([p, np.zeros_like(p[..., :1])], -1)
    ref = host_plan_ref_fn(model, vg, voxelize=True)(scan["points"],
                                                     scan["num_points"])

    def refuse(*a, **k):
        raise AssertionError("the serving path called a numpy builder")
    for mod in (sph, vh):
        for fn in [f for f in vars(mod) if f.endswith("_ref")]:
            monkeypatch.setattr(mod, fn, refuse)
    monkeypatch.setattr(vh, "_appearance", refuse)
    ours = host_plan_fn(model, vg, voxelize=True)(scan["points"],
                                                  scan["num_points"])
    assert_same(ours, ref)
    assert_same(vh.host_voxelize_batch(scan["points"], scan["num_points"],
                                       vg),
                {k: ref[k] for k in ("voxels", "coordinates",
                                     "num_points_per_voxel", "num_voxels")})


def test_builders_reject_what_the_native_code_cannot_take():
    with pytest.raises(ValueError, match="P < 4194304"):
        sph.point_order(np.zeros(sph.MAX_POINTS, np.int32), (4, 4, 4),
                        "hashed")
    with pytest.raises(ValueError, match="depths 1 to 64"):
        sph.subm_windows(np.zeros((4, 3), np.int32), (65, 8, 8))
    with pytest.raises(ValueError, match="hashed"):
        sph.point_order(np.zeros(4, np.int32), (4, 4, 4), "appearance")


def test_library_is_keyed_by_source_and_flags():
    path = csrc.library_path("hostplan")
    assert path.parent == csrc.BUILD_DIR
    assert path == csrc.build("hostplan") and path.is_file()
    assert csrc.build_log("hostplan").is_file()
    assert csrc.flags("hostplan") == ("-O3", "-shared", "-fPIC", "-std=c++17")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A hostplan.cc that does not compile: build() raises with g++'s
    message, leaves no library and no temporary file."""
    src = csrc.source("hostplan").read_text()
    (tmp_path / "hostplan.cc").write_text(
        src.replace("int64_t n_heads = 0", "int64_t n_heads = undeclared"))
    monkeypatch.setattr(csrc, "_HERE", tmp_path)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        csrc.build("hostplan")
    assert "undeclared" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []
