"""The two-stage crop-and-refine path, the port against the JAX package on
the CPU: ops/roi.py (points in boxes, roipool3d, rotated RoI Align) and
models/second_stage.py (crop_detections, RegHead and its loss), and the
refiner that composes them with PointModule trained end to end.

Mirrors tests/test_roi.py (all seven), tests/test_second_stage_e2e.py
(both; the 300-step one at its own size: B=4 scans of 512 points, 3
boxes each, 64 points a crop) and
tests/test_model_variants.py::test_crop_and_reghead_end_to_end.
Tolerances: masks and roipool3d's indices and ``empty`` equal; floats
within 1e-5 (rtol, atol 1e-5 of the largest), gradients within 1e-5
relative L2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.core.augment import points_in_rbbox
from det3d_tpu.models.second_stage import RegHead as JRegHead
from det3d_tpu.models.second_stage import crop_detections as jcrop
from det3d_tpu.ops import roi as jroi
from det3d_tpu_torch.models.necks import PointModule
from det3d_tpu_torch.models.second_stage import RegHead, crop_detections
from det3d_tpu_torch.ops import roi
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_second_stage_e2e import Refiner as JRefiner
from tests.test_second_stage_e2e import _scene

torch.set_num_threads(2)

TOL = 1e-5


def close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=TOL,
                               atol=TOL * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# ops/roi.py (tests/test_roi.py)
# ---------------------------------------------------------------------------

BOXES = np.array([[0.0, 0.0, 0.0, 2.0, 5.0, 2.0, 0.7],
                  [4.0, -3.0, 0.5, 1.5, 3.0, 1.5, -1.2],
                  [-5.0, 5.0, -0.5, 3.0, 3.0, 1.0, 0.0]], np.float32)


def test_points_in_boxes3d_matches_numpy_twin_and_jax(rng):
    pts = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    got = roi.points_in_boxes3d(t(pts), t(BOXES)).numpy()
    np.testing.assert_array_equal(
        got, points_in_rbbox(pts, BOXES, origin=(0.5, 0.5, 0.5)).T)
    np.testing.assert_array_equal(got, np.asarray(jroi.points_in_boxes3d(
        jnp.asarray(pts), jnp.asarray(BOXES))))


def test_points_in_boxes3d_extra_width():
    pts = torch.tensor([[1.2, 0.0, 0.0]])
    box = torch.tensor([[0, 0, 0, 2.0, 2.0, 2.0, 0.0]])
    assert not roi.points_in_boxes3d(pts, box)[0, 0]
    assert roi.points_in_boxes3d(pts, box, extra_width=1.0)[0, 0]


def test_roipool3d_budget_and_canonical(rng):
    """40 points in box 0, none in box 1 (the JAX test's scene): the first
    16 in-box points in point order, in the box's frame, padded slots
    zero, ``empty`` for box 1."""
    n, th = 64, 0.6
    pts = np.full((1, n, 3), 50.0, np.float32)
    inside = rng.uniform(-0.4, 0.4, (40, 3)).astype(np.float32)
    c, s = np.cos(th), np.sin(th)
    pts[0, :40] = np.stack([2.0 + inside[:, 0] * c + inside[:, 1] * s,
                            3.0 - inside[:, 0] * s + inside[:, 1] * c,
                            -1.0 + inside[:, 2]], -1)
    feats = rng.randn(1, n, 4).astype(np.float32)
    boxes = np.array([[[2.0, 3.0, -1.0, 1.0, 1.0, 1.0, th],
                       [-20.0, -20.0, 0.0, 1.0, 1.0, 1.0, 0.0]]], np.float32)
    px, pf, empty = roi.roipool3d(t(pts), t(feats), t(boxes),
                                  extra_width=0.0, sampled_pt_num=16)
    px, pf, empty = px.numpy(), pf.numpy(), empty.numpy()
    assert not empty[0, 0] and empty[0, 1]
    assert np.all(np.abs(px[0, 0]) <= 0.5 + 1e-5)
    assert np.all(px[0, 1] == 0.0) and np.all(pf[0, 1] == 0.0)
    np.testing.assert_allclose(pf[0, 0], feats[0, :16], rtol=1e-6)


@pytest.mark.parametrize("with_feats", [False, True])
def test_roipool3d_matches_jax(rng, with_feats):
    """Random scans and rotated boxes, a budget some boxes overflow, a
    validity mask: the indices roipool3d keeps equal JAX's (through the
    pooled features, which are the point index), ``empty`` equal, the
    canonical points within TOL."""
    b, n, m, k = 2, 400, 6, 8
    pts = rng.uniform(-6, 6, (b, n, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-5, 5, (b, m, 3)),
                            rng.uniform(1, 4, (b, m, 3)),
                            rng.uniform(-3, 3, (b, m, 1))], -1).astype(
                                np.float32)
    boxes[1, -1, :3] = 40.0                       # an empty RoI
    valid = rng.uniform(size=(b, n)) > 0.1
    idx = np.broadcast_to(np.arange(n, dtype=np.float32)[None, :, None],
                          (b, n, 1)).copy()
    feats = np.concatenate([idx, rng.randn(b, n, 2).astype(np.float32)],
                           -1) if with_feats else None
    ref = jroi.roipool3d(jnp.asarray(pts),
                         None if feats is None else jnp.asarray(feats),
                         jnp.asarray(boxes), extra_width=0.5,
                         sampled_pt_num=k, valid=jnp.asarray(valid))
    got = roi.roipool3d(t(pts), None if feats is None else t(feats),
                        t(boxes), extra_width=0.5, sampled_pt_num=k,
                        valid=t(valid))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    close(got[0].numpy(), ref[0], "pooled xyz")
    if with_feats:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        assert got[1] is None
    mask = roi.points_in_boxes3d(t(pts), t(boxes), 0.5) & t(valid)[:, None]
    i, f = roi._first_k_indices(mask, k)
    ji, jf = jax.vmap(jroi._first_k_indices, in_axes=(0, None))(
        jnp.asarray(mask.numpy()), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert (~f.any(-1)).any() and f.all(-1).any()


def ramp(axis, h=16, w=16):
    a = np.arange(w if axis == 1 else h, dtype=np.float32)
    shape = (1, w, 1) if axis == 1 else (h, 1, 1)
    return np.broadcast_to(a.reshape(shape), (h, w, 1)).copy()[None]


def test_rotated_roi_align_axis_aligned_oracle():
    out = roi.rotated_roi_align(t(ramp(1)), torch.tensor(
        [[0, 8.0, 8.0, 8.0, 4.0, 0.0]]), (2, 4), 1.0, sampling_ratio=2)
    assert out.shape == (1, 2, 4, 1)
    for row in range(2):
        np.testing.assert_allclose(out[0, row, :, 0].numpy(),
                                   [4.5, 6.5, 8.5, 10.5], atol=1e-4)


def test_rotated_roi_align_quarter_turn():
    feat = t(ramp(0))
    base = roi.rotated_roi_align(feat, torch.tensor(
        [[0, 8.0, 8.0, 8.0, 2.0, 0.0]]), (1, 4), 1.0, 2)
    rot = roi.rotated_roi_align(feat, torch.tensor(
        [[0, 8.0, 8.0, 8.0, 2.0, np.pi / 2]]), (1, 4), 1.0, 2)
    np.testing.assert_allclose(base[0, 0, :, 0].numpy(), [7.5] * 4,
                               atol=1e-4)
    np.testing.assert_allclose(rot[0, 0, :, 0].numpy(),
                               [4.5, 6.5, 8.5, 10.5], atol=1e-4)


def test_rotated_roi_align_out_of_bounds_zero():
    out = roi.rotated_roi_align(torch.ones(1, 8, 8, 1), torch.tensor(
        [[0, 100.0, 100.0, 4.0, 4.0, 0.3]]), (2, 2), 1.0, 2)
    np.testing.assert_allclose(out.numpy(), 0.0)


def test_rotated_roi_align_differentiable_and_matches_jax(rng):
    """Random features and RoIs over two maps, some RoIs across the map's
    edge: the output and its gradient in the features and the RoIs
    against JAX's autodiff."""
    feat = rng.randn(2, 12, 10, 3).astype(np.float32)
    rois = np.array([[0, 4.0, 4.0, 3.0, 2.0, 0.4],
                     [1, 7.5, 9.0, 5.0, 3.0, -1.1],
                     [1, 0.5, 11.0, 4.0, 4.0, 2.5],
                     [0, 5.2, 6.7, 6.0, 2.5, np.pi / 3]], np.float32)

    def jloss(f, r):
        return jnp.sum(jroi.rotated_roi_align(f, r, (3, 2), 0.8, 2) ** 2)

    jout, (jgf, jgr) = jax.jit(lambda f, r: (
        jroi.rotated_roi_align(f, r, (3, 2), 0.8, 2),
        jax.grad(jloss, argnums=(0, 1))(f, r)))(jnp.asarray(feat),
                                                jnp.asarray(rois))
    f, r = t(feat).requires_grad_(True), t(rois).requires_grad_(True)
    out = roi.rotated_roi_align(f, r, (3, 2), 0.8, 2)
    close(out.detach().numpy(), jout, "roi align")
    (out ** 2).sum().backward()
    assert np.abs(f.grad.numpy()).sum() > 0
    close(f.grad.numpy(), jgf, "d feat")
    close(r.grad.numpy()[:, 1:], np.asarray(jgr)[:, 1:], "d rois")


# ---------------------------------------------------------------------------
# models/second_stage.py
# ---------------------------------------------------------------------------

def test_crop_and_reghead_end_to_end(rng):
    """tests/test_model_variants.py:68 against JAX: crops and ``empty``
    equal, RegHead's predictions and every loss term within TOL, and the
    perfect prediction's z and height losses zero."""
    pts = rng.uniform(-5, 5, (2, 256, 3)).astype(np.float32)
    boxes = np.array(
        [[[0, 0, -1, 1.6, 3.9, 1.56, 0.3], [2, 2, -1, 1.6, 3.9, 1.56, 0.0]],
         [[1, -1, -1, 1.6, 3.9, 1.56, 1.0], [-2, 2, -1, 1.6, 3.9, 1.56, 0.5]]],
        np.float32)
    crops, empty = crop_detections(t(pts), None, t(boxes), sampled_pt_num=32)
    jcrops, jempty = jcrop(jnp.asarray(pts), None, jnp.asarray(boxes),
                           sampled_pt_num=32)
    assert crops.shape == (2, 2, 32, 3) and empty.shape == (2, 2)
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    close(crops.numpy(), jcrops, "crops")

    tasks = [dict(num_class=1, class_names=["Car"])]
    feats = rng.randn(4, 1, 1, 16).astype(np.float32)
    for z_type in ("top", "center"):
        jhead = JRegHead(tasks=tasks, iou_loss=True, z_type=z_type)
        v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                       train=False)
        jpreds = jhead.apply(v, jnp.asarray(feats), train=False)
        head = RegHead(tasks=tasks, in_channels=16, iou_loss=True,
                       z_type=z_type)
        head.load_state_dict(from_jax(v["params"], {}))
        preds = head(t(feats))
        assert len(preds) == 1 and preds[0].shape == (4, 1, 1, 2)
        close(preds[0].detach().numpy(), jpreds[0], "RegHead")
        example = dict(targets=rng.randn(4, 5).astype(np.float32) * 0.1,
                       ground_plane=np.zeros((4,), np.float32))
        losses = head.loss({k: t(x) for k, x in example.items()}, preds)
        jl = jhead.loss({k: jnp.asarray(x) for k, x in example.items()},
                        jpreds)
        assert set(losses[0]) == set(jl[0]) >= {
            "loss", "z_loss", "height_loss", "gp_loss", "iou_loss"}
        for k in jl[0]:
            close(float(losses[0][k].detach()), float(jl[0][k]), k)
    zero = head.loss(dict(targets=torch.zeros(4, 5),
                          ground_plane=torch.full((4,), -1.0 - 1.56)),
                     [torch.zeros(4, 1, 1, 2)])
    assert float(zero[0]["z_loss"]) == 0.0
    assert float(zero[0]["height_loss"]) == 0.0


class Refiner(torch.nn.Module):
    """tests/test_second_stage_e2e.py::Refiner in the port: crop encoder,
    per-RoI pointnet and z / h head (flax's submodule names)."""

    def __init__(self, sampled=64, layers=(64, 32)):
        super().__init__()
        self.sampled = sampled
        self.PointModule_0 = PointModule(sampled * 3, layers)
        self.RegHead_0 = RegHead(
            tasks=[dict(num_class=1, class_names=["Car"])],
            in_channels=layers[-1], anchor_height=1.56, anchor_center=-1.0)

    def forward(self, points, boxes):
        crops, empty = crop_detections(points, None, boxes,
                                       pool_extra_width=0.5,
                                       sampled_pt_num=self.sampled)
        b, m = crops.shape[:2]
        feats = self.PointModule_0(crops.reshape(b * m, self.sampled * 3))
        return [p.reshape(b, m, 2) for p in self.RegHead_0(feats)], empty


def refiner_from_jax(pts, boxes):
    jm = JRefiner()
    v = jax.jit(lambda p, b: jm.init(jax.random.PRNGKey(0), p, b,
                                     train=False))(jnp.asarray(pts),
                                                   jnp.asarray(boxes))
    model = Refiner()
    model.load_state_dict(from_jax(v["params"], v["batch_stats"]))
    return jm, v, model


def test_second_stage_learns_zh_residuals():
    """300 Adam steps (lr 3e-3) from JAX's initial weights on the JAX
    test's scene: the first loss within TOL of JAX's, the last below a
    tenth of the first (the JAX test's threshold), every crop full, the
    residuals recovered within 0.06 on average."""
    pts, noisy, resid = _scene(np.random.RandomState(42))
    jm, v, model = refiner_from_jax(pts, noisy)
    (jpreds, _), _ = jax.jit(lambda v_, p, b: jm.apply(
        v_, p, b, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(pts), jnp.asarray(noisy))
    jloss0 = float(jnp.mean((jpreds[0] - jnp.asarray(resid)) ** 2))
    pts_t, boxes_t, target = t(pts), t(noisy), t(resid)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    model.train()
    losses = []
    for _ in range(300):
        preds, _ = model(pts_t, boxes_t)
        loss = torch.mean((preds[0] - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    close(losses[0], jloss0, "first loss")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    model.eval()
    with torch.no_grad():
        preds, empty = model(pts_t, boxes_t)
    assert not empty.any()
    assert np.abs(preds[0].numpy() - resid).mean() < 0.06


def test_reghead_loss_composes_with_refiner():
    """The refiner's eval predictions and RegHead's loss with the IoU term
    on them, against JAX's, on the JAX test's 2 x 2 scene."""
    pts, noisy, resid = _scene(np.random.RandomState(42), b=2, m=2)
    jm, v, model = refiner_from_jax(pts, noisy)
    (jpreds, jempty), _ = jax.jit(lambda v_, p, b: jm.apply(
        v_, p, b, train=False, mutable=["batch_stats"]))(
            v, jnp.asarray(pts), jnp.asarray(noisy))
    with torch.no_grad():
        preds, empty = model.eval()(t(pts), t(noisy))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(jempty))
    close(preds[0].numpy(), jpreds[0], "refiner")
    tasks = [dict(num_class=1, class_names=["Car"])]
    targets = np.concatenate([np.zeros((4, 2)), resid.reshape(4, 2),
                              np.zeros((4, 1))], -1).astype(np.float32)
    gp = np.full((4,), -1.78, np.float32)
    got = RegHead(tasks=tasks, in_channels=32, iou_loss=True).loss(
        dict(targets=t(targets), ground_plane=t(gp)),
        [preds[0].reshape(4, 1, 1, 2)])
    ref = JRegHead(tasks=tasks, iou_loss=True).loss(
        dict(targets=jnp.asarray(targets), ground_plane=jnp.asarray(gp)),
        [jpreds[0].reshape(4, 1, 1, 2)])
    for k in ref[0]:
        close(float(got[0][k]), float(ref[0][k]), k)
    assert np.isfinite(float(got[0]["loss"]))
