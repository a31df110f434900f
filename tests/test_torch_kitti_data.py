"""The port's KITTI data path against the JAX package's: the synthetic
tree, the infos and gt database, the train and val pipelines' examples
(PointPillars, and SECOND with the HostPlan stage), the loader's batches,
the detections' conversion and the official evaluation.

Both packages' pipelines draw from the global ``np.random``; each
comparison seeds it before each side. The loader's workers: the JAX
package's take batches from one shared queue (which worker draws a batch
depends on timing); the port's take batch ``i`` on worker ``i % W``, so
its batches are held to ``replay`` of the same assignment, which the JAX
loader's dataset computes in-process too. The val pipeline draws nothing,
so there the JAX package's own fork workers are compared directly.
"""

import copy
import pickle

import numpy as np
import pytest

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import inject_host_plan as jinject_host_plan
from det3d_tpu.datasets import build_dataloader as jbuild_dataloader
from det3d_tpu.datasets import build_dataset as jbuild_dataset
from det3d_tpu.datasets.kitti import eval as jeval
from det3d_tpu_torch.apis.train import build_stack, inject_host_plan
from det3d_tpu_torch.datasets import build_dataloader, build_dataset
from det3d_tpu_torch.datasets.kitti import eval as keval
from det3d_tpu_torch.datasets.loader.loader import replay
from det3d_tpu_torch.utils import mini_kitti as mk
from tests import mini_kitti as jmk
from tests.test_kitti_dataset import _random_eval_image

EVAL_TOL = 1e-9


def assert_same(a, b, what=""):
    """Equal nested dicts / lists / arrays / scalars, dtypes included."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), what
        for k in b:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's tree and the JAX package's, 8 scenes each."""
    ours = tmp_path_factory.mktemp("kd_port")
    ref = tmp_path_factory.mktemp("kd_jax")
    gt = mk.make_tree(ours, n_scenes=8)
    jgt = jmk.make_tree(ref, n_scenes=8)
    return ours, ref, gt, jgt


# ---------------------------------------------------------------------------
# the tree, infos and gt database
# ---------------------------------------------------------------------------

def test_tree_files_equal_jax(trees):
    """Scenes, labels, calibs, ImageSets and the gt database's clusters,
    byte for byte."""
    ours, ref, gt, jgt = trees
    files = sorted(p.relative_to(ref) for p in ref.rglob("*")
                   if p.is_file() and p.suffix != ".pkl")
    assert sorted(p.relative_to(ours) for p in ours.rglob("*")
                  if p.is_file() and p.suffix != ".pkl") == files
    assert len([f for f in files if f.parts[0] == "gt_database"]) == 24
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f
    assert_same(gt, jgt)


@pytest.mark.parametrize("name", ["kitti_infos_train.pkl",
                                  "kitti_infos_val.pkl",
                                  "kitti_infos_trainval.pkl",
                                  "dbinfos_train.pkl"])
def test_infos_equal_jax(trees, name):
    ours, ref, _, _ = trees
    with open(ours / name, "rb") as f:
        a = pickle.load(f)
    with open(ref / name, "rb") as f:
        b = pickle.load(f)
    assert_same(a, b, name)
    assert len(b) > 0


# ---------------------------------------------------------------------------
# the pipelines' examples
# ---------------------------------------------------------------------------

def _datasets(root, config, split, seed, host_plan=False):
    """(port dataset, JAX dataset) of one split of a mini config over the
    tree at root, each built under ``np.random.seed(seed)`` (GT-AUG's
    queues shuffle at construction); with ``host_plan`` each config gets
    its package's HostPlan stage, whose entries must agree."""
    cfg = config(str(root))
    jcfg = copy.deepcopy(cfg)
    if host_plan:
        model, vg = build_stack(cfg, device="cpu")[:2]
        jmodel, jvg = jbuild_stack(jcfg)[:2]
        train = split == "train"
        assert inject_host_plan(cfg, model, vg, split=split, train=train)
        assert jinject_host_plan(jcfg, jmodel, jvg, split=split, train=train)
        assert_same(cfg["data"][split]["pipeline"][-1],
                    jcfg["data"][split]["pipeline"][-1], "HostPlan")
    np.random.seed(seed)
    ds = build_dataset(cfg["data"][split])
    np.random.seed(seed)
    jds = jbuild_dataset(jcfg["data"][split])
    return ds, jds


CASES = {"pointpillars_train": (mk.mini_config, "train", False),
         "pointpillars_val": (mk.mini_config, "val", False),
         "second_train_host_plan": (mk.mini_second_config, "train", True),
         "second_val_host_plan": (mk.mini_second_config, "val", True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_examples_equal_jax(trees, case):
    config, split, host_plan = CASES[case]
    ours, _, _, _ = trees
    ds, jds = _datasets(ours, config, split, 7, host_plan)
    assert len(ds) == len(jds) == 4
    n_gt = []
    for i in range(len(ds)):
        np.random.seed(100 + i)
        a = ds[i]
        np.random.seed(100 + i)
        b = jds[i]
        assert_same(a, b, f"{case}[{i}]")
        if host_plan:
            assert any(k.startswith("plan_") for k in a)
            assert "point_lin" in a and "point_perm" in a
        n_gt.append(int(a["gt_valid"].sum()) if split == "train" else 7)
    assert max(n_gt) > 6                    # GT-AUG pasted objects


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _loaders(root, split, workers, seed=3):
    ds, jds = _datasets(root, mk.mini_config, split, seed)
    return (build_dataloader(ds, 2, workers_per_gpu=workers, seed=seed),
            jbuild_dataloader(jds, 2, workers_per_gpu=workers, seed=seed))


def _epochs(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    return out


def test_loader_without_workers_equals_jax(trees):
    """Two epochs of the train pipeline in-process, both on the global
    stream from one seed."""
    ld, jld = _loaders(trees[0], "train", 0)
    np.random.seed(11)
    ours = _epochs(ld)
    np.random.seed(11)
    ref = _epochs(jld)
    assert len(ours) == len(ref) == 4
    assert_same(ours, ref)


def test_loader_workers_equal_replay_and_jax(trees):
    """Two epochs of the train pipeline on 2 fork workers: equal to the
    in-process replay of each worker's share, and to the JAX package's
    dataset computing the same shares (its workers' seeds)."""
    ld, jld = _loaders(trees[0], "train", 2)
    try:
        ours = _epochs(ld)
    finally:
        ld.close()
    assert len(ours) == 4
    assert_same(ours, replay(ld, (0, 1)))
    jld.num_workers = 2                  # replay only reads its settings
    assert_same(ours, replay(jld, (0, 1)))
    # each worker drew from its own stream: no two batches alike
    pts = [b["points"][:, :100].tobytes() for b in ours]
    assert len(set(pts)) == len(pts)


def test_val_loader_workers_equal_jax(trees):
    """The val pipeline draws nothing: the port's and the JAX package's
    fork workers give the same batches, in the sampler's order."""
    ld, jld = _loaders(trees[0], "val", 2)
    try:
        ours = _epochs(ld)
        ref = _epochs(jld)
    finally:
        ld.close()
        jld.close()
    assert_same(ours, ref)
    tokens = [m["token"] for b in ours for m in b["metadata"]]
    assert sorted(tokens[:4]) == ["4", "5", "6", "7"]


def test_loader_stops_early_and_resumes_the_streams(trees):
    """A pass left after its first batch: the workers finish it, so the
    next pass gives the replay's batches of a second whole pass."""
    ld, _ = _loaders(trees[0], "train", 2)
    try:
        ld.set_epoch(0)
        next(iter(ld))
        ours = _epochs(ld, (1,))
    finally:
        ld.close()
    assert_same(ours, replay(ld, (0, 1))[2:])


# ---------------------------------------------------------------------------
# detections -> KITTI annos -> the official evaluation
# ---------------------------------------------------------------------------

def _detections(gt, rng, tokens):
    out = {}
    for t in tokens:
        boxes = gt[int(t)].copy()
        boxes[:, :2] += rng.normal(0, 0.3, (len(boxes), 2))
        boxes[:, 6] += rng.normal(0, 0.1, len(boxes))
        out[t] = {"box3d_lidar": boxes.astype(np.float32),
                  "scores": rng.uniform(0.3, 1.0, len(boxes)).astype(
                      np.float32),
                  "label_preds": np.zeros((len(boxes),), np.int64)}
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluation_equals_jax(trees, seed):
    """Noisy detections of the val scenes (one scan without any):
    convert_detection_to_kitti_annos and the official and COCO results
    equal to JAX's (the strings equal, the APs within 1e-9)."""
    ours, _, gt, _ = trees
    ds, jds = _datasets(ours, mk.mini_config, "val", 0)
    dets = _detections(gt, np.random.RandomState(seed), ["4", "5", "7"])
    dets["6"] = {"box3d_lidar": np.zeros((0, 7), np.float32),
                 "scores": np.zeros((0,), np.float32),
                 "label_preds": np.zeros((0,), np.int64)}
    assert_same(ds.convert_detection_to_kitti_annos(dets),
                jds.convert_detection_to_kitti_annos(dets))
    res, _ = ds.evaluation(dets, None)
    jres, _ = jds.evaluation(dets, None)
    assert res["results"] == jres["results"]
    for kind in ("official", "coco"):
        a = res["detail"]["eval.kitti"][kind]
        b = jres["detail"]["eval.kitti"][kind]
        assert sorted(a) == sorted(b)
        for k in b:
            assert abs(a[k] - b[k]) <= EVAL_TOL, (kind, k)
    assert res["detail"]["eval.kitti"]["official"]["Car_3d_easy_loose"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_official_and_coco_eval_on_random_annos_equal_jax(seed):
    rng = np.random.RandomState(seed)
    images = [_random_eval_image(rng) for _ in range(25)]
    images.append(_random_eval_image(rng, force_empty_dt=True))
    images.append(_random_eval_image(rng, force_empty_gt=True))
    gts, dts = [g for g, _ in images], [d for _, d in images]
    classes = ["Car", "Pedestrian", "Cyclist"]
    for fn in ("get_official_eval_result", "get_coco_eval_result"):
        s, d = getattr(keval, fn)(gts, dts, classes)
        js, jd = getattr(jeval, fn)(gts, dts, classes)
        assert s == js
        assert sorted(d) == sorted(jd)
        for k in jd:
            assert abs(d[k] - jd[k]) <= EVAL_TOL, (fn, k)


def test_fused_statistics_matches_sequential_oracle():
    """compute_statistics_thresholds is bit-identical to looping the
    sequential official-protocol oracle over thresholds (the port's copy
    of tests/test_kitti_dataset.py's oracle test)."""
    rng = np.random.RandomState(0)
    images = [_random_eval_image(rng) for _ in range(30)]
    images.append(_random_eval_image(rng, force_empty_dt=True))
    images.append(_random_eval_image(rng, force_empty_gt=True))
    thresholds = np.linspace(0.0, 1.0, 41)
    for metric in (0, 1, 2):
        overlaps = keval.calculate_iou_partly(
            [g for g, _ in images], [d for _, d in images], metric)
        for current_class, min_overlap in ((0, 0.7), (0, 0.5), (1, 0.5)):
            for difficulty in (0, 1, 2):
                for gi, (gt, dt) in enumerate(images):
                    nv, ig, idt, dc = keval.clean_data(
                        gt, dt, current_class, difficulty)
                    gt_datas = np.concatenate(
                        [gt["bbox"], gt["alpha"][..., None]], 1)
                    dt_datas = np.concatenate(
                        [dt["bbox"], dt["alpha"][..., None],
                         dt["score"][..., None]], 1)
                    for compute_aos in (False, True):
                        fused = keval.compute_statistics_thresholds(
                            overlaps[gi], gt_datas, dt_datas, ig, idt, dc,
                            metric, min_overlap, thresholds, compute_aos)
                        for t, th in enumerate(thresholds):
                            tp, fp, fn, sim, _ = keval.compute_statistics(
                                overlaps[gi], gt_datas, dt_datas, ig, idt,
                                dc, metric, min_overlap, th, True,
                                compute_aos)
                            seq = [tp, fp, fn, sim if sim != -1 else 0.0]
                            assert np.allclose(fused[t], seq, atol=0), (
                                metric, current_class, difficulty, gi, t)


def _anno(names, bboxes, alphas, locs, dims, rots, scores=None, trunc=None,
          occl=None):
    n = len(names)
    a = {"name": np.array(names), "bbox": np.array(bboxes, np.float64),
         "alpha": np.array(alphas, np.float64),
         "location": np.array(locs, np.float64),
         "dimensions": np.array(dims, np.float64),
         "rotation_y": np.array(rots, np.float64)}
    if scores is not None:
        a["score"] = np.array(scores, np.float64)
    else:
        a["truncated"] = np.array(trunc or [0.0] * n, np.float64)
        a["occluded"] = np.array(occl or [0] * n, np.int64)
    return a


def test_official_eval_golden_fixture():
    """The hand-derived golden values of tests/test_kitti_dataset.py's
    fixture, on the port: 3 valid gts, TP scores {.9, .7, .6}; bbox AP
    100/11 (the detection on the DontCare box absorbed), bev/3d 60/11 (it
    counts as a FP), aos = bbox."""
    car = [4.0, 1.5, 1.8]
    gt1 = _anno(["Car", "Car", "DontCare"],
                [[100, 100, 200, 200], [300, 100, 400, 200],
                 [500, 100, 560, 160]],
                [0.5, -0.3, -10], [[5, 1.5, 20], [-4, 1.5, 30], [0, 0, 0]],
                [car, car, [-1, -1, -1]], [0.2, 1.0, -10],
                trunc=[0, 0, -1], occl=[0, 0, -1])
    dt1 = _anno(["Car", "Car", "Car", "Car"],
                [[100, 100, 200, 200], [300, 100, 400, 200],
                 [600, 100, 700, 200], [500, 100, 560, 160]],
                [0.5, -0.3, 0.1, 0.2],
                [[5, 1.5, 20], [-4, 1.5, 30], [10, 1.5, 50], [-10, 1.5, 60]],
                [car, car, car, car], [0.2, 1.0, 0.0, 0.0],
                scores=[0.9, 0.6, 0.8, 0.95])
    gt2 = _anno(["Car", "Van"], [[150, 120, 260, 240], [400, 120, 500, 220]],
                [1.2, 0.4], [[2, 1.4, 15], [-6, 1.5, 25]],
                [[3.9, 1.6, 1.7], [5, 2, 2.2]], [-0.7, 0.3])
    dt2 = _anno(["Car", "Car"], [[150, 120, 260, 240], [400, 120, 500, 220]],
                [1.2, 0.4], [[2, 1.4, 15], [-6, 1.5, 25]],
                [[3.9, 1.6, 1.7], [5, 2, 2.2]], [-0.7, 0.3],
                scores=[0.7, 0.85])
    _, detail = keval.get_official_eval_result([gt1, gt2], [dt1, dt2],
                                               ["Car"])
    ap_strict, ap_dc_fp = 100.0 / 11.0, 60.0 / 11.0
    for diff in ("easy", "moderate", "hard"):
        for tag in ("", "_loose"):
            assert abs(detail[f"Car_bbox_{diff}{tag}"] - ap_strict) < 1e-9
            assert abs(detail[f"Car_bev_{diff}{tag}"] - ap_dc_fp) < 1e-9
            assert abs(detail[f"Car_3d_{diff}{tag}"] - ap_dc_fp) < 1e-9
            assert abs(detail[f"Car_aos_{diff}{tag}"] - ap_strict) < 1e-9
    _, coco = keval.get_coco_eval_result([gt1, gt2], [dt1, dt2], ["Car"])
    for diff in ("easy", "moderate", "hard"):
        assert abs(coco[f"Car_bbox_coco_{diff}"] - ap_strict) < 1e-9
        assert abs(coco[f"Car_bev_coco_{diff}"] - ap_dc_fp) < 1e-9
        assert abs(coco[f"Car_3d_coco_{diff}"] - ap_dc_fp) < 1e-9
