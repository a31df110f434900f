"""The port's host box code, native point ops, augmentations and GT-AUG
sampler against the JAX package's.

- core/box_np.py: every function array-equal to JAX's on the same inputs;
- csrc/pointops.cc (built with g++ here) against its numpy twins
  (core/augment.py's ``*_ref`` and ``intersection_area_corners``) and
  JAX's core/augment.py: masks and collisions equal, areas within 1e-6
  (measured 0: the twins follow the C++ operation for operation);
- each augmentation and ``noise_per_object`` under ``np.random.seed(s)``
  equal to JAX's (the same draws in the same order);
- ``DataBaseSampler.sample_all`` equal to JAX's on a mini tree;
- a failed pointops build raises with g++'s output (no numpy fallback).
"""

import numpy as np
import pytest

from det3d_tpu.core import augment as jaug
from det3d_tpu.core import box_np as jbox
from det3d_tpu.core.db_sampler import build_dbsampler as jbuild_dbsampler
from det3d_tpu_torch import csrc
from det3d_tpu_torch.core import augment as aug
from det3d_tpu_torch.core import box_np
from det3d_tpu_torch.core.db_sampler import build_dbsampler
from det3d_tpu_torch.utils import mini_kitti as mk

AREA_TOL = 1e-6


def boxes7(rng, n, spread=20.0):
    """(n, 7) [x y z w l h r] float64 lidar boxes."""
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-2, 0, (n, 1)),
        rng.uniform(0.5, 4.5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        axis=1)


def calib(rng):
    rect = np.eye(4)
    rect[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    v2c = np.eye(4)
    v2c[:3, :3] = mk.TR_VELO_TO_CAM[:3, :3]
    v2c[:3, 3] = rng.normal(size=3)
    return rect, v2c


# ---------------------------------------------------------------------------
# box_np
# ---------------------------------------------------------------------------

def _box_np_cases(rng):
    b = boxes7(rng, 9)
    rect, v2c = calib(rng)
    pts = rng.normal(size=(9, 5, 3))
    cam = np.concatenate([rng.uniform(-5, 5, (9, 2)),
                          rng.uniform(5, 40, (9, 1))], 1)
    return {
        "limit_period": (lambda m: m.limit_period(b[:, 6] * 3, 0.5,
                                                  2 * np.pi)),
        "rotation_3d_in_axis": (lambda m: np.stack([
            m.rotation_3d_in_axis(pts, b[:, 6], axis=a) for a in (0, 1, 2)])),
        "corners_nd": (lambda m: np.concatenate([
            m.corners_nd(b[:, 3:5]).reshape(9, -1),
            m.corners_nd(b[:, 3:6], origin=(0.5, 1.0, 0.5)).reshape(9, -1)],
            1)),
        "center_to_corner_box3d": (lambda m: m.center_to_corner_box3d(
            b[:, :3], b[:, 3:6], b[:, 6], origin=[0.5, 1.0, 0.5], axis=1)),
        "center_to_corner_box2d": (lambda m: m.center_to_corner_box2d(
            b[:, :2], b[:, 3:5], b[:, 6])),
        "corner_to_standup_nd": (lambda m: m.corner_to_standup_nd(
            m.center_to_corner_box2d(b[:, :2], b[:, 3:5], b[:, 6]))),
        "project_to_image": (lambda m: m.project_to_image(cam, mk.P2)),
        "camera_to_lidar": (lambda m: m.camera_to_lidar(cam, rect, v2c)),
        "lidar_to_camera": (lambda m: m.lidar_to_camera(b[:, :3], rect,
                                                        v2c)),
        "box_camera_to_lidar": (lambda m: m.box_camera_to_lidar(b, rect,
                                                                v2c)),
        "box_lidar_to_camera": (lambda m: m.box_lidar_to_camera(b, rect,
                                                                v2c)),
        "change_box3d_center_": (lambda m: _centered(m, b)),
        "iou_2d": (lambda m: m.iou_2d(
            m.corner_to_standup_nd(m.center_to_corner_box2d(
                b[:, :2] / 8, b[:, 3:5], b[:, 6])),
            m.corner_to_standup_nd(m.center_to_corner_box2d(
                b[::-1, :2] / 8, b[:, 3:5], b[:, 6])))),
    }


def _centered(m, b):
    out = b.copy()
    m.change_box3d_center_(out, [0.5, 0.5, 0], [0.5, 0.5, 0.5])
    return out


@pytest.mark.parametrize("fn", sorted(_box_np_cases(
    np.random.RandomState(0))))
def test_box_np_equals_jax(fn):
    case = _box_np_cases(np.random.RandomState(5))[fn]
    ours, ref = case(box_np), case(jbox)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# pointops: native, numpy twins, JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_pts,n_box", [(0, 4000, 12), (1, 300, 1),
                                              (2, 0, 5), (3, 50, 0)])
def test_points_in_rbbox_native_equals_twins_and_jax(seed, n_pts, n_box):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-22, 22, (n_pts, 2)),
                          rng.uniform(-3, 1, (n_pts, 1)),
                          rng.uniform(0, 1, (n_pts, 1))], 1).astype(
                              np.float32)
    b = boxes7(rng, n_box, spread=8.0)
    for origin in ((0.5, 0.5, 0.5), (0.5, 0.5, 0.0)):
        ours = aug.points_in_rbbox(pts, b, origin)
        assert ours.shape == (n_pts, n_box) and ours.dtype == bool
        np.testing.assert_array_equal(ours,
                                      aug.points_in_rbbox_ref(pts, b, origin))
        np.testing.assert_array_equal(ours,
                                      jaug.points_in_rbbox(pts, b, origin))
    if n_box > 1 and n_pts:
        assert 0 < ours.sum() < ours.size


@pytest.mark.parametrize("seed,n,k", [(0, 30, 30), (1, 100, 7), (2, 1, 1),
                                      (3, 0, 4)])
def test_box_collision_native_equals_twin(seed, n, k):
    rng = np.random.RandomState(seed)
    a = boxes7(rng, n, spread=6.0)[:, [0, 1, 3, 4, 6]]
    b = boxes7(rng, k, spread=6.0)[:, [0, 1, 3, 4, 6]]
    ours = aug.box_collision(a, b)
    np.testing.assert_array_equal(ours, aug.box_collision_ref(a, b))
    if n > 1:
        assert 0 < ours.sum() < ours.size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersection_area_native_equals_twin_and_jax(seed):
    """Paired areas at GT-AUG's sizes (the gt database's boxes against a
    scene's, and against themselves: every pair disjoint, touching,
    nested or identical)."""
    rng = np.random.RandomState(seed)
    a = aug.corners_bev(boxes7(rng, 40, spread=4.0)[:, [0, 1, 3, 4, 6]])
    b = aug.corners_bev(boxes7(rng, 40, spread=4.0)[:, [0, 1, 3, 4, 6]])
    ca = np.concatenate([np.repeat(a, 40, 0), a])
    cb = np.concatenate([np.tile(b, (40, 1, 1)), a])
    ours = aug.intersection_area(ca, cb)
    twin = aug.intersection_area_corners(ca, cb)
    np.testing.assert_allclose(ours, twin, rtol=0, atol=AREA_TOL)
    np.testing.assert_allclose(ours, jaug.intersection_area_corners(ca, cb),
                               rtol=0, atol=AREA_TOL)
    assert (ours > 0).sum() > 40
    np.testing.assert_array_equal(aug.box_collision_test(a, b),
                                  jaug.box_collision_test(a, b))


def test_failed_pointops_build_raises(tmp_path, monkeypatch):
    """A pointops.cc that does not compile: build() raises with g++'s
    message and leaves no library; nothing falls back to numpy."""
    src = csrc.source("pointops").read_text()
    (tmp_path / "pointops.cc").write_text(
        src.replace("double total = 0.0;", "double total = undeclared;", 1))
    monkeypatch.setattr(csrc, "_HERE", tmp_path)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        csrc.build("pointops")
    assert "undeclared" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []


# ---------------------------------------------------------------------------
# augmentations under one seed
# ---------------------------------------------------------------------------

def _scene(seed, n_box=8, n_pts=3000, box_dim=7):
    rng = np.random.RandomState(100 + seed)
    b = boxes7(rng, n_box, spread=15.0)
    if box_dim == 9:
        b = np.concatenate([b[:, :6], rng.normal(size=(n_box, 2)), b[:, 6:]],
                           1)
    pts = np.concatenate([rng.uniform(-20, 20, (n_pts, 2)),
                          rng.uniform(-3, 1, (n_pts, 1)),
                          rng.uniform(0, 1, (n_pts, 1))], 1).astype(
                              np.float32)
    return b, pts


AUGS = {
    "random_flip": lambda m, b, p: m.random_flip(b, p, 0.5),
    "random_flip_both": lambda m, b, p: m.random_flip_both(b, p, 0.5),
    "global_rotation": lambda m, b, p: m.global_rotation(b, p,
                                                         [-0.78, 0.78]),
    "global_scaling": lambda m, b, p: m.global_scaling(b, p, 0.95, 1.05),
    "global_translate": lambda m, b, p: m.global_translate(
        b, p, [0.2, 0.2, 0.1]),
    "noise_per_object": lambda m, b, p: m.noise_per_object(
        b, p, None, rotation_perturb=[-0.15, 0.15],
        center_noise_std=[0.25, 0.25, 0.25]),
}


# noise_per_object takes 7-dim boxes in both packages; the global ones
# also 9-dim nuScenes boxes with velocities
@pytest.mark.parametrize("name,box_dim", [
    (n, d) for n in sorted(AUGS) for d in (7, 9)
    if d == 7 or n != "noise_per_object"])
def test_augmentation_equals_jax_under_one_seed(name, box_dim):
    for seed in range(4):
        outs = []
        for mod in (aug, jaug):
            b, p = _scene(seed, box_dim=box_dim)
            np.random.seed(seed)
            outs.append(AUGS[name](mod, b, p) + (np.random.uniform(),))
        (b0, p0, r0), (b1, p1, r1) = outs
        np.testing.assert_array_equal(b0, b1)
        np.testing.assert_array_equal(p0, p1)
        assert r0 == r1                 # the streams stand at one place


def test_noise_per_object_moves_boxes_and_their_points():
    b, p = _scene(0, n_box=6)
    b0, p0 = b.copy(), p.copy()
    np.random.seed(0)
    aug.noise_per_object(b, p, None, rotation_perturb=[-0.15, 0.15],
                         center_noise_std=[0.25, 0.25, 0.25])
    moved = np.abs(b - b0).max(axis=1) > 0
    assert moved.any()
    inside = aug.points_in_rbbox(p0, b0)[:, moved].any(axis=1)
    assert (np.abs(p - p0).max(axis=1)[inside] > 0).all()
    np.testing.assert_array_equal(p[~aug.points_in_rbbox(p0, b0).any(1)],
                                  p0[~aug.points_in_rbbox(p0, b0).any(1)])


# ---------------------------------------------------------------------------
# GT-AUG
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("augdb_kitti")
    mk.make_tree(root, n_scenes=8)
    return root


def _db_cfg(root, rate=1.0):
    return dict(type="GT-AUG", enable=True,
                db_info_path=str(root / "dbinfos_train.pkl"),
                sample_groups=[dict(Car=12)],
                db_prep_steps=[dict(filter_by_min_num_points=dict(Car=5)),
                               dict(filter_by_difficulty=[-1])],
                rate=rate)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_sampler_sample_all_equals_jax(tree, seed):
    """Built under one seed (its per-class queues shuffle at once), then
    four scenes sampled in turn: the same objects, boxes and points."""
    samplers = []
    for build in (build_dbsampler, jbuild_dbsampler):
        np.random.seed(seed)
        samplers.append(build(_db_cfg(tree)))
    rng = np.random.RandomState(seed)
    for scene in range(4):
        gt = boxes7(rng, 3 + scene, spread=10.0)
        names = np.array(["Car"] * len(gt))
        outs = []
        for s in samplers:
            np.random.seed(seed * 10 + scene)
            outs.append(s.sample_all(str(tree), gt, names, 4))
        ours, ref = outs
        assert (ours is None) == (ref is None)
        if ref is None:
            continue
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert len(ref["gt_boxes"]) > 0


def test_db_sampler_disabled_and_filters(tree):
    assert build_dbsampler(dict(_db_cfg(tree), enable=False)) is None
    np.random.seed(0)
    s = build_dbsampler(_db_cfg(tree))
    assert all(i["num_points_in_gt"] >= 5 for i in s.db_infos["Car"])
    assert all(i["difficulty"] != -1 for i in s.db_infos["Car"])
