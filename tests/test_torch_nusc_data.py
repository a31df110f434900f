"""The port's nuScenes and Lyft data path against the JAX package's: the
synthetic tree, the infos and gt database, multi-sweep loading and CBGS
resampling in the shipped configs' pipelines, the loader, the native NDS
and Lyft evaluations, eval2d and the ground plane, and the 6-column point
width through the first layers and one CBGS train step; then
train_detector, resume and eval_detector over the tree on the CPU.

The trees are utils/mini_nuscenes.py's (8 scenes of 4 keyframes, 2 sweeps
between keyframes) and the JAX package's tests/mini_nuscenes.py's, each
prepared by its own package (10-sweep infos: the shipped configs' names;
a keyframe with fewer past sweeps pads its list). The configs are
``configs/nusc_cbgs_voxelnet.py``, ``configs/nusc_pointpillars.py`` and
``configs/lyft_cbgs_voxelnet.py`` as shipped, their ``Reformat`` cut to
MAX_POINTS points (a 10-sweep mini scan holds 16800). Both packages'
pipelines draw from the global ``np.random`` (the sweeps, the
augmentations); each comparison seeds it before each side. Host numpy on
both sides gives equal arrays; the evaluations' metrics are held within
EVAL_TOL.
"""

import copy
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

import chip_smoke as cs
from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.apis.train import batch_to_device as jbatch_to_device
from det3d_tpu.cli import _lyft_data_prep as jlyft_prep
from det3d_tpu.cli import _nuscenes_data_prep as jnusc_prep
from det3d_tpu.core import eval2d as jeval2d
from det3d_tpu.datasets import build_dataloader as jbuild_dataloader
from det3d_tpu.datasets import build_dataset as jbuild_dataset
from det3d_tpu.datasets.lyft import eval as jlyft_eval
from det3d_tpu.datasets.nuscenes import nusc_eval as jnusc_eval
from det3d_tpu.datasets.nuscenes import tables as jtables
from det3d_tpu.datasets.pipelines import loading as jloading
from det3d_tpu.datasets.utils import ground_plane as jground
from det3d_tpu.utils.config import Config as JConfig
from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                        example_width, init_state,
                                        train_detector, with_point_width)
from det3d_tpu_torch.cli import _lyft_data_prep, _nuscenes_data_prep
from det3d_tpu_torch.core import eval2d
from det3d_tpu_torch.datasets import build_dataloader, build_dataset
from det3d_tpu_torch.datasets.loader.loader import collate, replay
from det3d_tpu_torch.datasets.lyft import eval as lyft_eval
from det3d_tpu_torch.datasets.nuscenes import nusc_eval, tables
from det3d_tpu_torch.datasets.pipelines import loading
from det3d_tpu_torch.datasets.utils import ground_plane
from det3d_tpu_torch.parallel.train import make_train_step
from det3d_tpu_torch.utils import mini_nuscenes as mn
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from tests import mini_nuscenes as jmn
from tests.test_torch_kitti_data import assert_same

torch.set_num_threads(2)

EVAL_TOL = 1e-9
LOSS_REL = 1e-4         # one CBGS train step's loss against JAX's
SCENES = 8
MAX_POINTS = 32768
CFGS = {"cbgs": cs.CBGS_CFG, "nusc_pp": cs.NUSC_PP_CFG, "lyft": cs.LYFT_CFG}
ENV = {"cbgs": "NUSC_DATA", "nusc_pp": "NUSC_DATA", "lyft": "LYFT_DATA"}
CUT = {"cbgs": (6.4, 512), "nusc_pp": (12.8, 2000)}
# the cut configs' nms_pre_max_size (shipped: 1000): the plain NMS twin
# computes the IoU of every pair on the CPU
PRE_MAX = 300


def prepare(root, lyft, port):
    """A mini tree at ``root`` prepared by one package: nuScenes infos and
    gt database, or (``lyft``) Lyft's categories and infos."""
    (mn if port else jmn).make_tree(root, n_scenes=SCENES)
    np.random.seed(0)
    if lyft:
        mn.lyft_categories(root)
        (_lyft_data_prep if port else jlyft_prep)(str(root), mn.VERSION)
    else:
        (_nuscenes_data_prep if port else jnusc_prep)(str(root), mn.VERSION)
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: (the port's tree, the JAX package's)} for nuScenes and
    Lyft."""
    return {name: tuple(prepare(tmp_path_factory.mktemp(f"{name}_{side}"),
                                name == "lyft", side == "port")
                        for side in ("port", "jax"))
            for name in ("nusc", "lyft")}


def rooted(tree, root):
    """``tree`` with every string's ``root`` prefix replaced by ROOT."""
    if isinstance(tree, dict):
        return {k: rooted(v, root) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rooted(v, root) for v in tree]
    if isinstance(tree, str):
        return tree.replace(str(root), "ROOT")
    return tree


def load_config(name, root, port=True, cut_model=False):
    """A shipped config's dict, read with ``root`` as its data root, its
    Reformat cut to MAX_POINTS; ``cut_model``: the range and the voxel
    cap cut as CUT says (chip_smoke.py::sparse_config), widths as
    shipped."""
    os.environ[ENV[name]] = str(root)
    try:
        if cut_model:
            cfg = cs.sparse_config(CFGS[name], cut=CUT[name])
            if name == "nusc_pp":
                cfg["model"]["reader"]["pc_range"] = \
                    cfg["voxel_generator"]["range"]
            cfg["test_cfg"]["nms"]["nms_pre_max_size"] = PRE_MAX
        else:
            c = (Config if port else JConfig).fromfile(CFGS[name])
            cfg = {k: copy.deepcopy(c[k]) for k in c.keys()}
    finally:
        os.environ.pop(ENV[name])
    for split in ("train", "val"):
        for stage in cfg["data"][split]["pipeline"]:
            if stage["type"] == "Reformat":
                stage["max_points"] = MAX_POINTS
    return cfg


# ---------------------------------------------------------------------------
# the tree, the tables, the infos and the gt database
# ---------------------------------------------------------------------------

def test_tree_files_equal_jax(tmp_path):
    """utils/mini_nuscenes.py at its defaults writes the JAX package's
    tree byte for byte, and the same truth."""
    ours, ref = tmp_path / "port", tmp_path / "jax"
    gt, jgt = mn.make_tree(ours), jmn.make_tree(ref)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*")
                   if p.is_file())
    assert sorted(p.relative_to(ours) for p in ours.rglob("*")
                  if p.is_file()) == files
    assert len(files) == 2 * 4 + 2 * 3 * 2 + 10 + 1   # bins, tables, splits
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f
    assert_same(gt, jgt)


def test_clutter_keyword_sets_the_points_a_sweep(tmp_path):
    """``clutter`` sets the clutter rows of every sweep; 3 objects of 60
    points each stay."""
    mn.make_tree(tmp_path, n_scenes=2, sweeps_between=1, clutter=40)
    for f in (tmp_path / "samples" / "LIDAR_TOP").glob("*.bin"):
        pts = np.fromfile(f, np.float32).reshape(-1, 5)
        assert pts.shape == (3 * 60 + 40, 5)


def test_lyft_categories_rename(tmp_path):
    mn.make_tree(tmp_path, n_scenes=2)
    mn.lyft_categories(tmp_path)
    cats = json.loads((tmp_path / mn.VERSION / "category.json").read_text())
    assert [c["name"] for c in cats] == ["car", "pedestrian"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_geometry_equals_jax(seed):
    """quat_to_rotmat, quaternion_yaw, yaw_to_quat and transform_matrix
    (forward and inverse) on seeded quaternions, exactly."""
    r = np.random.RandomState(seed)
    for _ in range(20):
        q = r.normal(size=4)
        t = r.normal(0, 10, 3)
        assert np.array_equal(tables.quat_to_rotmat(q),
                              jtables.quat_to_rotmat(q))
        assert tables.quaternion_yaw(q) == jtables.quaternion_yaw(q)
        yaw = float(r.uniform(-np.pi, np.pi))
        assert tables.yaw_to_quat(yaw) == jtables.yaw_to_quat(yaw)
        for inv in (False, True):
            assert np.array_equal(
                tables.transform_matrix(t, q, inverse=inv),
                jtables.transform_matrix(t, q, inverse=inv))


@pytest.mark.parametrize("name", ["infos_train_10sweeps_withvelo.pkl",
                                  "infos_val_10sweeps_withvelo.pkl",
                                  "dbinfos_train_10sweeps.pkl"])
def test_nuscenes_infos_equal_jax(trees, name):
    """Field by field, floats exact, paths under each tree's root; the
    keyframes without enough past sweeps pad their 9: the first keyframe
    of a scene with itself (no transform), the rest by repeats."""
    ours, ref = trees["nusc"]
    raw = pickle.load(open(ours / name, "rb"))
    want = rooted(pickle.load(open(ref / name, "rb")), ref)
    assert_same(rooted(raw, ours), want)
    if name.startswith("infos_train"):
        assert len(raw) == SCENES // 2 * 4
        first = raw[0]["sweeps"]
        assert len(first) == 9 and first[0]["transform_matrix"] is None
        assert all(s is first[0] for s in first[1:])
        later = raw[1]["sweeps"]
        assert later[0]["transform_matrix"] is not None
        assert later[-1] is later[-2]          # 3 sweeps, then repeats


def test_nuscenes_gt_database_files_equal_jax(trees):
    """The gt database's clusters (6 columns: the time lag appended)."""
    ours, ref = trees["nusc"]
    files = sorted(p.name for p in (ref / "gt_database").iterdir())
    assert sorted(p.name for p in (ours / "gt_database").iterdir()) == files
    assert len(files) == SCENES // 2 * 4 * 3
    for f in files:
        a = (ours / "gt_database" / f).read_bytes()
        assert a == (ref / "gt_database" / f).read_bytes(), f
        assert len(a) % (6 * 4) == 0


@pytest.mark.parametrize("split", ["train", "val"])
def test_lyft_infos_equal_jax(trees, split):
    ours, ref = trees["lyft"]
    name = f"lyft_infos_{split}_10sweeps.pkl"
    got = rooted(pickle.load(open(ours / name, "rb")), ours)
    assert_same(got, rooted(pickle.load(open(ref / name, "rb")), ref))
    assert set(np.concatenate([i["gt_names"] for i in got])) == {
        "car", "pedestrian"}


def test_read_sweep_equals_jax(trees):
    """One padded (no transform) and one transformed sweep."""
    ours, ref = trees["nusc"]
    infos = pickle.load(open(ours / "infos_train_10sweeps_withvelo.pkl",
                             "rb"))
    for sweep in (infos[0]["sweeps"][0], infos[2]["sweeps"][0]):
        got = loading.read_sweep(sweep)
        want = jloading.read_sweep(sweep)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the pipelines and the loader
# ---------------------------------------------------------------------------

def _datasets(trees, name, split):
    """The port's and the JAX package's dataset of a shipped config's
    split over their own trees."""
    tree = trees["lyft" if name == "lyft" else "nusc"]
    ours = build_dataset(load_config(name, tree[0])["data"][split])
    ref = jbuild_dataset(load_config(name, tree[1], port=False)
                         ["data"][split])
    return ours, ref


@pytest.mark.parametrize("case", [("cbgs", "train"), ("cbgs", "val"),
                                  ("nusc_pp", "train"), ("lyft", "train")])
def test_pipeline_examples_equal_jax(trees, case):
    """Every example of the split at one seed: the sweeps drawn, the 6
    columns, the 9-dim boxes, array-equal (GT-AUG from the nuScenes gt
    database in nuScenes PointPillars' pipeline); CBGS's resampled
    length and order equal."""
    name, split = case
    ours, ref = _datasets(trees, name, split)
    assert [i["token"] for i in ours._nusc_infos] == \
        [i["token"] for i in ref._nusc_infos]
    assert len(ours) == len(ref)
    if split == "train":
        # car and pedestrian of 10 (7) classes: each kept 1/10 (1/7) of
        # the duplicated count's share
        assert len(ours) == {"lyft": 2 * int(16 / 7 * 2),
                             "nusc_pp": 2 * int(16 * 0.2),
                             "cbgs": 2 * int(16 * 0.2)}[name]
    else:
        assert len(ours) == SCENES // 2 * 4
    np.random.seed(5)
    got = [ours[i] for i in range(len(ours))]
    np.random.seed(5)
    want = [ref[i] for i in range(len(ref))]
    tree = trees["lyft" if name == "lyft" else "nusc"]
    for a, b in zip(got, want):
        assert_same(rooted(a, tree[0]), rooted(b, tree[1]))
        assert a["points"].shape == (MAX_POINTS, 6)
        if split == "train":
            assert a["gt_boxes"].shape[-1] == 9
        n = int(a["num_points"])
        lags = np.unique(a["points"][:n, 5])
        assert lags.min() == 0.0
    if name == "cbgs":
        assert all(int(a["num_points"]) == 10 * 1680 for a in got)


def _loaders(trees, workers):
    ours, ref = _datasets(trees, "cbgs", "train")
    return (build_dataloader(ours, 2, workers_per_gpu=workers, seed=3),
            jbuild_dataloader(ref, 2, workers_per_gpu=0, seed=3))


def _epochs(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    return out


def test_loader_without_workers_equals_jax(trees):
    ld, jld = _loaders(trees, 0)
    np.random.seed(11)
    ours = _epochs(ld)
    np.random.seed(11)
    ref = _epochs(jld)
    assert len(ours) == len(ref) == 6
    assert_same(rooted(ours, trees["nusc"][0]), rooted(ref, trees["nusc"][1]))


def test_loader_workers_equal_replay_and_jax(trees):
    """CBGS's train pipeline on 2 fork workers: equal to their in-process
    replay, and to the JAX package's dataset computing the same shares."""
    ld, jld = _loaders(trees, 2)
    try:
        ours = _epochs(ld)
    finally:
        ld.close()
    assert len(ours) == 6
    assert_same(ours, replay(ld, (0, 1)))
    jld.num_workers = 2                  # replay only reads its settings
    assert_same(rooted(ours, trees["nusc"][0]),
                rooted(replay(jld, (0, 1)), trees["nusc"][1]))


# ---------------------------------------------------------------------------
# the evaluations
# ---------------------------------------------------------------------------

def _detections(infos, class_names, kind, seed):
    """Detections by token: the gt boxes (``perfect``), the gt boxes moved
    by up to 0.8 m (``noisy``), or random boxes and labels
    (``random``)."""
    r = np.random.RandomState(seed)
    dets = {}
    for info in infos:
        boxes = np.asarray(info["gt_boxes"], np.float64).copy()
        labels = np.array([class_names.index(n) if n in class_names else 0
                           for n in info["gt_names"]])
        if kind == "noisy":
            boxes[:, :2] += r.uniform(-0.8, 0.8, (len(boxes), 2))
            boxes[:, 6:8] += r.normal(0, 0.5, (len(boxes), 2))
        elif kind == "random":
            n = r.randint(0, 12)
            boxes = np.concatenate([
                r.uniform(-30, 30, (n, 2)), r.uniform(-2, 1, (n, 1)),
                r.uniform(0.5, 5, (n, 3)), r.normal(0, 2, (n, 2)),
                r.uniform(-np.pi, np.pi, (n, 1))], 1)
            labels = r.randint(0, len(class_names), n)
        dets[info["token"]] = {
            "box3d_lidar": boxes.astype(np.float32),
            "scores": r.uniform(0.05, 1.0, len(boxes)).astype(np.float32),
            "label_preds": labels.astype(np.int64),
        }
    return dets


def assert_metrics_close(a, b, what=""):
    """Nested metrics equal in keys, numbers within EVAL_TOL (NaN where
    the other is NaN)."""
    if isinstance(b, dict):
        assert sorted(a, key=str) == sorted(b, key=str), what
        for k in b:
            assert_metrics_close(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_metrics_close(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=0, atol=EVAL_TOL,
                                   equal_nan=True, err_msg=what)
    elif isinstance(b, (float, int, np.floating, np.integer)):
        if np.isnan(b):
            assert np.isnan(a), what
        else:
            assert abs(a - b) <= EVAL_TOL, (what, a, b)
    else:
        assert a == b, what


@pytest.mark.parametrize("kind", ["perfect", "noisy", "random"])
def test_nuscenes_evaluation_equals_jax(trees, kind):
    """NuScenesDataset.evaluation over the val split (CBGS's 10 classes):
    the metrics and the printed lines equal JAX's."""
    ours, ref = _datasets(trees, "cbgs", "val")
    names = list(ours._class_names)
    dets = _detections(ours._nusc_infos, names, kind, seed=7)
    got, _ = ours.evaluation(dets, None)
    want, _ = ref.evaluation(dets, None)
    assert_metrics_close(got["detail"], want["detail"])
    assert got["results"]["nusc"] == want["results"]["nusc"]
    m = got["detail"]["eval.nusc"]
    if kind == "perfect":
        assert m["mean_ap"] > 0.99 and m["nd_score"] > 0.9
    assert "NDS:" in got["results"]["nusc"]


@pytest.mark.parametrize("kind", ["perfect", "noisy", "random"])
def test_lyft_evaluation_equals_jax(trees, kind):
    ours, ref = _datasets(trees, "lyft", "val")
    names = list(ours._class_names)
    dets = _detections(ours._nusc_infos, names, kind, seed=9)
    got, _ = ours.evaluation(dets, None)
    want, _ = ref.evaluation(dets, None)
    assert_metrics_close(got["detail"], want["detail"])
    assert got["results"]["lyft"] == want["results"]["lyft"]
    if kind == "perfect":
        assert got["detail"]["eval.lyft"]["mAP"] > 0.99


@pytest.mark.parametrize("seed", [0, 1])
def test_d3_iou_lidar_equals_jax(seed):
    r = np.random.RandomState(seed)
    a = np.concatenate([r.uniform(-5, 5, (7, 3)), r.uniform(0.5, 4, (7, 3)),
                        r.uniform(-np.pi, np.pi, (7, 1))], 1)
    b = a[r.permutation(7)[:5]] + r.normal(0, 0.3, (5, 7))
    got = lyft_eval.d3_iou_lidar(a, b)
    assert np.array_equal(got, jlyft_eval.d3_iou_lidar(a, b))
    assert got.shape == (7, 5) and (got >= 0).all() and (got <= 1).all()


def test_nds_golden_fixture():
    """tests/test_nuscenes_dataset.py's hand-derived golden values on the
    port's nusc_eval.evaluate: 4 car GTs matched in score order with x
    errors 0.1-0.4 m, AP 1 at every threshold, the closed-form ATE over
    the recall grid, the other TP errors 0."""
    def box(x, score=None, err=0.0):
        b = {"detection_name": "car", "translation": (x + err, 0.0, 1.0),
             "size": (2.0, 4.5, 1.6), "yaw": 0.3, "velocity": (1.0, 0.0),
             "attribute_name": "vehicle.moving", "num_pts": 10}
        if score is not None:
            b["detection_score"] = score
        return b

    xs = [5.0, 15.0, 25.0, 35.0]
    gts = {"tok": [box(x) for x in xs]}
    preds = {"tok": [box(x, score=s, err=e) for x, s, e in
                     zip(xs, [0.9, 0.8, 0.7, 0.6], [0.1, 0.2, 0.3, 0.4])]}
    m = nusc_eval.evaluate(gts, preds, classes=["car"])
    for th, ap in m["label_aps"]["car"].items():
        assert abs(ap - 1.0) < 1e-12, (th, ap)
    grid = np.linspace(0, 1, 101)[11:]
    ate = float(np.where(grid <= 0.25, 0.1, 0.1 + 0.2 * (grid - 0.25))
                .mean())
    assert abs(m["tp_errors"]["trans_err"] - ate) < 1e-12
    for k in ("scale_err", "orient_err", "vel_err", "attr_err"):
        assert abs(m["tp_errors"][k]) < 1e-12, k
    assert abs(m["nd_score"] - (5.0 + (1.0 - ate) + 4.0) / 10.0) < 1e-12
    assert_metrics_close(m, jnusc_eval.evaluate(gts, preds, ["car"]))


def test_attribute_heuristic_equals_jax():
    from det3d_tpu.datasets.nuscenes.nuscenes import NuScenesDataset as J
    from det3d_tpu_torch.datasets.nuscenes.nuscenes import NuScenesDataset
    for name in list(nusc_eval.CLASS_RANGE) + ["other"]:
        for v in ((0.0, 0.0), (0.1, 0.1), (0.3, 0.0), (-2.0, 1.0)):
            assert NuScenesDataset._attr_for(name, v) == J._attr_for(name, v)


# ---------------------------------------------------------------------------
# eval2d and the ground plane
# ---------------------------------------------------------------------------

def _boxes2d(r, n, scores=False):
    xy = r.uniform(0, 50, (n, 2))
    wh = r.uniform(2, 20, (n, 2))
    out = np.concatenate([xy, xy + wh], 1)
    if scores:
        out = np.concatenate([out, r.uniform(0, 1, (n, 1))], 1)
    return out.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval2d_equals_jax(seed):
    """bbox_overlaps (iou, iof), average_precision (area, 11points),
    eval_map with ignored GTs, eval_recalls on seeded boxes."""
    r = np.random.RandomState(seed)
    a, b = _boxes2d(r, 9), _boxes2d(r, 6)
    for mode in ("iou", "iof"):
        assert np.array_equal(eval2d.bbox_overlaps(a, b, mode),
                              jeval2d.bbox_overlaps(a, b, mode))
    rec = np.sort(r.uniform(0, 1, 12))
    prec = r.uniform(0, 1, 12)
    for mode in ("area", "11points"):
        assert eval2d.average_precision(rec, prec, mode) == \
            jeval2d.average_precision(rec, prec, mode)
    n_img, n_cls = 4, 3
    gts = [_boxes2d(r, 5) for _ in range(n_img)]
    labels = [r.randint(1, n_cls + 1, 5) for _ in range(n_img)]
    ignore = [r.uniform(size=5) < 0.2 for _ in range(n_img)]
    dets = [[np.concatenate([g[:3] + r.normal(0, 2, (3, 4)).astype(
        np.float32), r.uniform(0, 1, (3, 1)).astype(np.float32)], 1)
        for _ in range(n_cls)] for g in gts]
    got = eval2d.eval_map(dets, gts, labels, gt_ignore=ignore, iou_thr=0.5)
    want = jeval2d.eval_map(dets, gts, labels, gt_ignore=ignore, iou_thr=0.5)
    assert_metrics_close(list(got), list(want))
    props = [_boxes2d(r, 8, scores=True) for _ in range(n_img)]
    kw = dict(proposal_nums=(1, 4, 8), iou_thrs=(0.3, 0.5, 0.7))
    assert np.array_equal(eval2d.eval_recalls(gts, props, **kw),
                          jeval2d.eval_recalls(gts, props, **kw))
    for ds in ("kitti", "nuscenes"):
        assert eval2d.get_classes(ds) == jeval2d.get_classes(ds)


@pytest.mark.parametrize("seed", [0, 1])
def test_ground_plane_equals_jax(seed):
    """fit_plane_lse, fit_plane_ransac (its sampling under one seed) and
    estimate_ground_plane on a noisy ground with outliers."""
    r = np.random.RandomState(seed)
    n = 400
    ground = np.stack([r.uniform(0, 60, n), r.uniform(-30, 30, n),
                       -1.7 + 0.02 * r.randn(n)], -1)
    pts = np.vstack([ground, r.uniform([0, -30, -1.0], [60, 30, 2.0],
                                       (100, 3))]).astype(np.float32)
    assert np.array_equal(ground_plane.fit_plane_lse(ground),
                          jground.fit_plane_lse(ground))
    got = ground_plane.fit_plane_ransac(pts, inlier_thresh=0.08, seed=seed)
    want = jground.fit_plane_ransac(pts, inlier_thresh=0.08, seed=seed)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    assert abs(got[0][3] - 1.7) < 0.05
    for x, y in zip(ground_plane.estimate_ground_plane(pts, seed=seed),
                    jground.estimate_ground_plane(pts, seed=seed)):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the point width: 6 columns through the first layers and a train step
# ---------------------------------------------------------------------------

def _example_batch(trees, cfg, seed=4):
    ds = build_dataset(cfg["data"]["train"])
    np.random.seed(seed)
    return collate([ds[0], ds[1]])


def random_variables(shapes, seed):
    """Numpy variables of flax's variable shapes: kernels normal with a
    1/sqrt(fan-in) spread, BN statistics, affine parameters and biases
    drawn as tests/test_torch_modules.py::randomize draws them."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "var":
            v = r.uniform(0.5, 2.0, s.shape)
        elif leaf in ("mean", "bias"):
            v = r.normal(0.0, 0.2, s.shape)
        elif leaf == "scale":
            v = r.uniform(0.5, 1.5, s.shape)
        else:
            v = r.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_stacks(trees):
    """For CBGS and nuScenes PointPillars (cut, widths as shipped): the
    config, JAX's stack, its variables' shapes as flax infers them at
    ``init`` on a collated mini-nuScenes batch (6 columns; traced, not
    compiled) filled with random values, and that batch."""
    from det3d_tpu.parallel.train import build_example as jbuild_example
    out = {}
    for name in ("cbgs", "nusc_pp"):
        cfg = load_config(name, trees["nusc"][0], cut_model=True)
        batch = _example_batch(trees, cfg)
        jm, jvg = jbuild_stack(copy.deepcopy(cfg))[:2]

        def init(b, jm=jm, jvg=jvg):
            ex = jbuild_example(b, jvg, [], [], with_targets=False)
            return jm.init(jax.random.PRNGKey(0), ex["voxels"],
                           ex["num_points_per_voxel"], ex["coordinates"],
                           train=False)
        shapes = jax.eval_shape(init, jbatch_to_device(batch))
        var = random_variables(
            {k: shapes[k] for k in ("params", "batch_stats")}, seed=2)
        out[name] = cfg, jm, jvg, var, batch
    return out


@pytest.mark.parametrize("name", ["cbgs", "nusc_pp"])
def test_first_layers_take_the_data_width_as_jax(jax_stacks, name):
    """The port's stack built as wide as the split's examples
    (``example_width``: 6) has every parameter of JAX's stack initialized
    on the same batch, shape for shape: a (27, 6, 16) stem for CBGS, an
    11-wide PFN (6 + 5 decorations) for PointPillars; as the config says
    (5) it would not."""
    cfg, _, _, var, _ = jax_stacks[name]
    width = example_width(cfg["data"]["train"])
    assert width == 6
    model = build_stack(cfg, "cpu", point_width=width)[0]
    sd = from_jax(var["params"], var["batch_stats"])
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in sd.items()}
    first = {"cbgs": ("backbone.SparseConvBN_0.weight", (27, 6, 16)),
             "nusc_pp": ("reader.pfn_0.linear.weight", (64, 11))}[name]
    assert shapes[first[0]] == first[1]
    narrow = build_stack(cfg, "cpu")[0].state_dict()[first[0]]
    assert tuple(narrow.shape) != first[1]


def test_with_point_width_leaves_a_pillar_middle():
    model = {"reader": {"type": "PillarFeatureNet", "num_input_features": 5},
             "backbone": {"type": "PointPillarsScatter",
                          "num_input_features": 64}}
    out = with_point_width(model, 6)
    assert out["reader"]["num_input_features"] == 6
    assert out["backbone"]["num_input_features"] == 64
    assert model["reader"]["num_input_features"] == 5     # not mutated
    vfe = {"reader": {"type": "VoxelFeatureExtractorV3"},
           "backbone": {"type": "SpMiddleResNetFHD",
                        "num_input_features": 5}}
    assert with_point_width(vfe, 6)["backbone"]["num_input_features"] == 6


def test_example_width_restores_the_random_stream(trees):
    cfg = load_config("cbgs", trees["nusc"][0])
    np.random.seed(3)
    before = np.random.get_state()
    assert example_width(cfg["data"]["train"]) == 6
    after = np.random.get_state()
    assert all(np.array_equal(a, b) for a, b in zip(before, after))


def test_cbgs_train_step_loss_equals_jax(jax_stacks):
    """One CBGS train step on the cut grid from the mini-nuScenes batch (6
    columns) and JAX's host training plan: the port's loss, from
    from_jax's weights, within LOSS_REL of JAX's loss op by op (``apply``
    in training mode outside ``jax.jit``)."""
    import jax.numpy as jnp
    from det3d_tpu.parallel.train import build_example as jbuild_example
    cfg, jm, jvg, var, batch = jax_stacks["cbgs"]
    jasg, jcids = jbuild_stack(copy.deepcopy(cfg))[2:4]
    keys = ("points", "num_points", "gt_boxes", "gt_classes", "gt_valid")
    plan = jhost_plan_fn(jm, jvg, train=True, voxelize=True)(
        batch["points"], batch["num_points"])
    feed = dict({k: batch[k] for k in keys},
                **{k: np.asarray(v) for k, v in plan.items()})
    jb = {k: jnp.asarray(v) for k, v in feed.items()}
    ex = jbuild_example(jb, jvg, jasg, jcids, with_targets=True)
    preds, _ = jm.apply(var, ex["voxels"], ex["num_points_per_voxel"],
                        ex["coordinates"], train=True,
                        mutable=["batch_stats"],
                        plan={k[5:]: v for k, v in jb.items()
                              if k.startswith("plan_")})
    ref = float(sum(jm.loss(ex, preds)["loss"]))

    model, vg, asg, cids, _ = build_stack(cfg, "cpu", point_width=6)
    model.load_state_dict(from_jax(var["params"], var["batch_stats"]))
    state, _ = init_state(cfg, model, 10)
    metrics = make_train_step(state, vg, asg, cids)(feed)
    assert float(metrics["num_pos_task0"]) > 0
    assert abs(float(metrics["loss"]) - ref) <= LOSS_REL * abs(ref)


# ---------------------------------------------------------------------------
# train_detector, resume and eval_detector over the tree, on the CPU
# ---------------------------------------------------------------------------

def test_train_resume_eval_cbgs(trees, tmp_path_factory):
    """The cut CBGS config over the tree (B=2, 2 fork workers, the
    HostPlan stage): one epoch with a work dir, a resume for a second,
    then eval_detector on val, whose NDS lines cover every val token."""
    root = trees["nusc"][0]
    work = tmp_path_factory.mktemp("nusc_work")
    cfg = load_config("cbgs", root, cut_model=True)
    cfg["data"].update(samples_per_gpu=2, workers_per_gpu=2)
    cfg["total_epochs"] = 1
    cfg["tensorboard"] = False
    trainer = train_detector(cfg, work_dir=str(work), device="cpu")
    assert trainer.iter == int(trainer.state.step) == 3
    assert cfg["data"]["train"]["pipeline"][-1]["type"] == "HostPlan"
    stem = trainer.state.model.backbone.SparseConvBN_0.weight
    assert tuple(stem.shape) == (27, 6, 16)
    cfg["total_epochs"] = 2
    trainer = train_detector(cfg, work_dir=str(work), resume_from=str(work),
                             device="cpu")
    assert trainer.epoch == 2 and trainer.iter == int(trainer.state.step) \
        == 6
    results, dets = eval_detector(cfg, trainer.state, work_dir=str(work),
                                  device="cpu")
    val = pickle.load(open(root / "infos_val_10sweeps_withvelo.pkl", "rb"))
    assert sorted(dets) == sorted(i["token"] for i in val)
    text = results["results"]["nusc"]
    assert "NDS:" in text and "mAP:" in text
    assert (work / "metrics_summary.json").is_file()
    lo, hi = np.split(np.asarray(cfg["test_cfg"]["post_center_limit_range"]),
                      2)
    for d in dets.values():
        # centers and scores; the sizes are exp of a head trained 6 steps
        # (its BN running statistics near their initial values)
        centers = d["box3d_lidar"][:, :3]
        assert d["box3d_lidar"].shape[1] == 9
        assert ((centers >= lo) & (centers <= hi)).all()
        assert ((d["scores"] >= 0) & (d["scores"] <= 1)).all()
