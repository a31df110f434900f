"""Double-flip TTA and the sparse middles from points alone (the JAX
package's ``plan=None`` path): the port against the JAX package, on the
CPU.

- ``MultiGroupHead.predict_tta`` against JAX's on the same random heads of
  a 4B batch, for the cut CBGS head (6 tasks, 9-dim boxes with
  velocities) and the cut KITTI 3-class head (direction classifiers):
  labels and valid equal, boxes and scores within 1e-5 absolute, the
  scores kept clear of the score threshold and of the pre-NMS cut;
- SECOND's and CBGS's middles without a plan (cut ranges, full widths,
  weights through ``from_jax``) against JAX's ``plan=None`` middles: both
  in fp32 (``precision``), though the configs serve bf16 from a host
  plan, within the ``TOL = 1e-4`` of tests/test_torch_cbgs.py;
- the whole TTA step (``make_predict_step`` with ``double_flip``) on the
  cut CBGS against JAX's ``make_predict_step(double_flip=True)``: the
  heads of the 4B scans within 1e-4, the detections as above at 1e-4;
- the mirror property of tests/test_multitask_velocity.py::
  test_double_flip_tta_symmetry, which holds for any weights because the
  ensemble of four flips is closed under flips: a mirrored scene gives
  mirrored detections within 1e-4.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.parallel.train import make_predict_step as jmake_predict_step
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.parallel.predict import (double_flip_batch,
                                              make_predict_step)
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_cbgs import (CLS_GAIN, N_TASKS, PRE_MAX,
                                   cbgs_batch, cbgs_config, random_variables)
from tests.test_torch_kitti_all import kitti_all_config
from tests.test_torch_second import jax_stack, second_config
from tests.test_torch_second import batch as second_batch  # noqa: F401

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
HEAD_ATOL = 1e-5            # predict_tta on the same heads: decode only
MIRROR_ATOL = 1e-4
# scores clear of the cuts on the same random heads: both sides take the
# sigmoid of one fp32 logit, a few ulps (~6e-8 at 0.5) apart at most
HEAD_MARGIN = 1e-6
State = collections.namedtuple("State", "params batch_stats")


def check_detections(out, det, atol):
    """Valid masks and labels equal; boxes and scores of the valid
    detections within ``atol``."""
    out = {k: np.asarray(v) for k, v in out.items()}
    np.testing.assert_array_equal(out["valid"], det["valid"])
    np.testing.assert_array_equal(out["label_preds"], det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    np.testing.assert_allclose(out["box3d_lidar"][v], det["box3d_lidar"][v],
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out["scores"][v], det["scores"][v], rtol=0,
                               atol=atol)


def merged_scores(head, nc, nv=4):
    """(B, nv * A) top class scores of one task's 4B head outputs, merged
    over the nv variants of each scan as predict_tta merges them."""
    logits = np.asarray(head["cls_preds"], np.float64)
    b4 = logits.shape[0]
    s = (1.0 / (1.0 + np.exp(-logits.reshape(b4, -1, nc)))).max(-1)
    return s.reshape(nv, b4 // nv, -1).transpose(1, 0, 2).reshape(b4 // nv,
                                                                  -1)


def clear_of_the_cuts(heads, num_classes, test_cfg, margin):
    """Every task's merged scores lie ``margin`` or more from the score
    threshold, and the pre-NMS top-k cut falls in a gap of ``margin`` or
    more, so both sides select the same candidates."""
    thr = test_cfg["score_threshold"]
    k = test_cfg["nms"]["nms_pre_max_size"]
    for h, nc in zip(heads, num_classes):
        s = merged_scores(h, nc)
        assert np.abs(s - thr).min() > margin
        n_valid = (s >= thr).sum(axis=1)
        srt = -np.sort(-s, axis=1)
        assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > margin)).all()


# ---------------------------------------------------------------------------
# predict_tta on random heads
# ---------------------------------------------------------------------------

def random_heads(head, fm, b4, thr, seed):
    """Random NHWC head outputs of a 4B batch: box regression N(0, 0.3),
    direction logits N(0, 1), class logits N(0, 1.2) shifted by each
    task's cut_bias (20 to 250 candidates a scan and task, none near the
    threshold)."""
    r = np.random.RandomState(seed)
    h, w = fm
    out = []
    for a, nc in zip(head.num_anchor_per_locs, head.num_classes):
        d = {"box_preds": r.normal(0, 0.3, (b4, h, w, a * head.box_n_dim)),
             "cls_preds": r.normal(0, 1.2, (b4, h, w, a * nc))}
        d["cls_preds"] += cut_bias(merged_logits(d, nc), thr)
        if head.use_direction_classifier:
            d["dir_cls_preds"] = r.normal(0, 1, (b4, h, w, a * 2))
        out.append({k: v.astype(np.float32) for k, v in d.items()})
    return out


@pytest.mark.parametrize("name", ["cbgs", "kitti_all"])
def test_predict_tta_matches_jax(name):
    cfg = cbgs_config() if name == "cbgs" else kitti_all_config()
    cfg["test_cfg"]["nms"]["nms_pre_max_size"] = PRE_MAX
    jmodel, _, jasg, _, jtest = jbuild_stack(
        cbgs_config(jax_side=True) if name == "cbgs" else kitti_all_config())
    jtest["nms"]["nms_pre_max_size"] = PRE_MAX
    model, vg, asg, _, test_cfg = build_stack(cfg, device="cpu")
    head = model.bbox_head
    b4 = 4 * 2
    osf = int(cfg["assigner"]["out_size_factor"])
    fm = (vg.grid_size[1] // osf, vg.grid_size[0] // osf)
    heads = random_heads(head, fm, b4, test_cfg["score_threshold"], seed=4)
    clear_of_the_cuts(heads, head.num_classes, test_cfg, HEAD_MARGIN)
    jex = {"anchors": [jnp.broadcast_to(jnp.asarray(a.anchors_flat)[None],
                                        (b4,) + a.anchors_flat.shape)
                       for a in jasg]}
    ref = jax.jit(lambda e, h: jmodel.predict_tta(e, h, jtest))(
        jex, [{k: jnp.asarray(v) for k, v in h.items()} for h in heads])
    ex = {"anchors": [a.anchors_on("cpu")[None].expand(
        b4, *a.anchors_flat.shape) for a in asg]}
    out = model.predict_tta(ex, [{k: torch.from_numpy(v) for k, v in
                                  h.items()} for h in heads], test_cfg)
    check_detections(out, {k: np.asarray(v) for k, v in ref.items()},
                     HEAD_ATOL)
    assert len(np.unique(np.asarray(ref["label_preds"])[
        np.asarray(ref["valid"])])) > 1


# ---------------------------------------------------------------------------
# the middles without a plan
# ---------------------------------------------------------------------------

def test_second_middle_plan_none_matches_jax(second_batch):  # noqa: F811
    jmodel, vg, asg, _, _, _, var = jax_stack("bf16", True, second_batch)
    cids = jbuild_stack(second_config("bf16", jax_side=True))[3]
    ex = jbuild_example({k: jnp.asarray(v) for k, v in
                         second_batch.items()}, vg, asg, cids,
                        with_targets=False)
    bbv = {c: var[c]["backbone"] for c in ("params", "batch_stats")}
    ref = np.asarray(jax.jit(lambda v, x, c: jmodel.backbone.apply(
        v, x, c, jmodel.grid_size, train=False))(
            bbv, ex["voxels"], ex["coordinates"]))
    assert ref.dtype == np.float32
    model = build_stack(second_config("bf16"), device="cpu")[0]
    model.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        out = model.backbone(torch.from_numpy(np.array(ex["voxels"])),
                             torch.from_numpy(np.array(ex["coordinates"])),
                             model.grid_size)
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 40, 40, 128)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_cbgs_middle_plan_none_matches_jax():
    batch = cbgs_batch(2, 3000, seed=3)
    jmodel, vg, asg, cids, _ = jbuild_stack(cbgs_config("bf16",
                                                        jax_side=True))
    ex = jbuild_example({k: jnp.asarray(v) for k, v in batch.items()}, vg,
                        asg, cids, with_targets=False)
    feats = jmodel.reader.apply({}, ex["voxels"], ex["num_points_per_voxel"])
    var = random_variables(
        lambda *a, **k: jmodel.backbone.init(*a, input_shape=jmodel.grid_size,
                                             **k),
        feats, ex["coordinates"], seed=1)
    ref = np.asarray(jax.jit(lambda v, x, c: jmodel.backbone.apply(
        v, x, c, jmodel.grid_size, train=False))(var, feats,
                                                 ex["coordinates"]))
    model = build_stack(cbgs_config("bf16"), device="cpu")[0]
    sd = from_jax({"backbone": var["params"]},
                  {"backbone": var["batch_stats"]})
    model.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = model.backbone(torch.from_numpy(np.array(feats)),
                             torch.from_numpy(np.array(ex["coordinates"])),
                             model.grid_size)
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 32, 32, 256)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# the whole TTA step, and the mirror property
# ---------------------------------------------------------------------------

def merged_logits(head, nc, nv=4):
    """(B, nv * A) top class logits of one task's 4B head outputs, merged
    as merged_scores merges the scores."""
    logits = np.asarray(head["cls_preds"], np.float64)
    b4 = logits.shape[0]
    top = logits.reshape(b4, -1, nc).max(-1)
    return top.reshape(nv, b4 // nv, -1).transpose(1, 0, 2).reshape(
        b4 // nv, -1)


def cut_bias(logits, thr, lo=20, hi=250):
    """The class bias that puts the score threshold ``thr`` in the widest
    gap of one task's merged top logits (B, N) (computed with a zero bias)
    that keeps between ``lo`` and ``hi`` candidates in every scan: below
    the pre-NMS cut, and above the many equal scores of empty cells."""
    vals = np.unique(logits)
    mids = (vals[1:] + vals[:-1]) / 2
    kept = (logits[:, None, :] > mids[None, :, None]).sum(-1)   # (B, M)
    ok = ((kept >= lo) & (kept <= hi)).all(axis=0)
    assert ok.any()
    gaps = np.where(ok, np.diff(vals), -1.0)
    c = mids[np.argmax(gaps)]
    return float(np.log(thr / (1 - thr)) - c)


@pytest.fixture(scope="module")
def tta():
    """JAX's and the port's TTA steps on the cut CBGS (bf16 served from a
    plan, fp32 here), random weights, B=2 scans of points alone. The class
    convs are scaled by CLS_GAIN and each task's biases set by cut_bias,
    so that 20 to 250 candidates a scan and task pass the threshold, none
    near it: random weights give thousands of scores within 1e-5 of each
    other, and equal ones over empty cells, which two sums in other fp32
    orders could rank apart."""
    batch = cbgs_batch(2, 3000, seed=3)
    jmodel, vg, asg, cids, jtest = jbuild_stack(cbgs_config(
        "bf16", jax_side=True))
    jtest = dict(jtest, double_flip=True,
                 nms=dict(jtest["nms"], nms_pre_max_size=PRE_MAX))
    flipped = {k: np.asarray(v) for k, v in double_flip_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
    ex = jbuild_example({k: jnp.asarray(v) for k, v in flipped.items()}, vg,
                        asg, cids, with_targets=False)
    var = random_variables(jmodel.init, ex["voxels"],
                           ex["num_points_per_voxel"], ex["coordinates"],
                           seed=2)
    apply = jax.jit(lambda v, e: jmodel.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False))
    for t in range(N_TASKS):
        cls = var["params"]["bbox_head"][f"task_{t}"]["conv_cls"]
        cls["kernel"] = cls["kernel"] * CLS_GAIN
        cls["bias"] = np.zeros_like(cls["bias"])
    num_classes = [len(t["class_names"]) for t in
                   cbgs_config()["tasks"]]
    heads = apply(var, ex)
    for t, nc in enumerate(num_classes):
        cls = var["params"]["bbox_head"][f"task_{t}"]["conv_cls"]
        cls["bias"] = np.full_like(cls["bias"], cut_bias(
            merged_logits(heads[t], nc), jtest["score_threshold"]))
    heads = apply(var, ex)
    det = jmake_predict_step(jmodel, vg, asg, cids, jtest)(
        State(var["params"], var["batch_stats"]),
        {k: jnp.asarray(v) for k, v in batch.items()})

    model, tvg, tasg, tcids, ttest = build_stack(cbgs_config("bf16"),
                                                 device="cpu")
    ttest = dict(ttest, double_flip=True,
                 nms=dict(ttest["nms"], nms_pre_max_size=PRE_MAX))
    model.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                          strict=True)
    step = make_predict_step(model, tvg, tasg, tcids, ttest)
    with torch.no_grad():
        vox = tvg.generate_batch(torch.from_numpy(flipped["points"]),
                                 torch.from_numpy(flipped["num_points"]))
        theads = model(vox["voxels"], vox["num_points_per_voxel"],
                       vox["coords"])
    return dict(batch=batch, heads=jax.tree_util.tree_map(np.asarray, heads),
                theads=theads, det={k: np.asarray(v) for k, v in det.items()},
                step=step, out=step(batch), test_cfg=ttest,
                num_classes=num_classes)


def test_tta_step_heads_match_jax(tta):
    """The heads of the 4B scans within TOL, and their scores clear of the
    cuts by ten times the largest difference between the two sides (as
    tests/test_torch_cbgs.py::test_predict_scores_clear_of_the_cuts)."""
    pairs = list(zip(tta["heads"], tta["theads"]))
    for h, th in pairs:
        for k in h:
            np.testing.assert_allclose(th[k].numpy(), h[k], **TOL)
    margin = 10 * max(
        np.abs(merged_scores(h, nc) - merged_scores(
            {k: v.numpy() for k, v in th.items()}, nc)).max()
        for (h, th), nc in zip(pairs, tta["num_classes"]))
    assert margin < 1e-5
    clear_of_the_cuts(tta["heads"], tta["num_classes"], tta["test_cfg"],
                      margin)


def test_tta_step_matches_jax(tta):
    out = tta["out"]
    assert out["box3d_lidar"].shape == (2, N_TASKS * 83, 9)
    check_detections(out, tta["det"], TOL["atol"])
    assert len(np.unique(tta["det"]["label_preds"][tta["det"]["valid"]])) > 1


def angdiff(a, b):
    return np.abs(np.angle(np.exp(1j * (a - b))))


@pytest.mark.parametrize("sx,sy", [(1, -1), (-1, 1), (-1, -1)])
def test_tta_mirrored_scene_gives_mirrored_detections(tta, sx, sy):
    """Scan 0 and its mirror image: the same detections, mirrored."""
    one = {k: v[:1] for k, v in tta["batch"].items()}
    mirror = dict(one, points=one["points"] * np.asarray(
        [sx, sy, 1, 1, 1], np.float32))
    out = {k: v[0].numpy() for k, v in tta["step"](one).items()}
    out_m = {k: v[0].numpy() for k, v in tta["step"](mirror).items()}
    v, vm = out["valid"], out_m["valid"]
    assert v.sum() == vm.sum() > 0
    a = np.argsort(-out["scores"][v], kind="stable")
    b = np.argsort(-out_m["scores"][vm], kind="stable")
    np.testing.assert_allclose(out["scores"][v][a], out_m["scores"][vm][b],
                               rtol=0, atol=MIRROR_ATOL)
    np.testing.assert_array_equal(out["label_preds"][v][a],
                                  out_m["label_preds"][vm][b])
    bx, bm = out["box3d_lidar"][v][a], out_m["box3d_lidar"][vm][b]
    sign = np.asarray([sx, sy, 1, 1, 1, 1, sx, sy], np.float32)
    np.testing.assert_allclose(bx[:, :8] * sign, bm[:, :8], rtol=0,
                               atol=MIRROR_ATOL)
    yaw = bx[:, 8].copy()
    if sy < 0:
        yaw = -yaw
    if sx < 0:
        yaw = np.pi - yaw
    assert angdiff(yaw, bm[:, 8]).max() < MIRROR_ATOL
