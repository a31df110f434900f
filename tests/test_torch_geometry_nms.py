"""The port's box geometry and NMS against the JAX package, on the CPU.

Float outputs (corners, areas, intersections) agree within 1e-5 absolute:
both sides run the same fp32 operations in the same order, and the only
differences are the last-bit rounding of sin/cos and of the products.
Keep masks and NMS indices must be exactly equal; the inputs are checked
to keep every IoU at least 1e-4 away from the threshold, so rounding
cannot flip a decision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.core import box_ops as jbox
from det3d_tpu.core import geometry as jgeo
from det3d_tpu.ops import nms as jnms
from det3d_tpu.ops.nms_pallas import rotated_nms_keep as pallas_keep
from det3d_tpu_torch.core import box_ops as tbox
from det3d_tpu_torch.core import geometry as tgeo
from det3d_tpu_torch.ops import nms as tnms
from det3d_tpu_torch.ops.nms_cuda import (pairwise_iou_from_corners,
                                          rotated_nms_keep,
                                          rotated_nms_keep_ref)

torch.set_num_threads(2)

FLOAT_TOL = 1e-5      # fp32, same operation order on both sides
IOU_MARGIN = 1e-4     # min |IoU - threshold| over valid pairs
THR = 0.5


def _boxes(k, seed, spread=40.0):
    """Clustered, overlapping rotated boxes [x, y, w, l, r] (K, 5)."""
    r = np.random.RandomState(seed)
    centers = r.uniform(0, spread, (k, 2)).astype(np.float32)
    h = k - k // 2
    centers[k // 2:] = centers[:h] + r.normal(0, 1.0, (h, 2)).astype(
        np.float32)
    return np.concatenate(
        [centers, r.uniform(1.5, 4.5, (k, 2)).astype(np.float32),
         r.uniform(-np.pi, np.pi, (k, 1)).astype(np.float32)], 1)


def _port_corners_area(boxes):
    """(K, 5) numpy -> the port's (1, K, 8) CCW corners and (1, K) areas."""
    c = tgeo._ccw(tgeo.box_to_corners(torch.from_numpy(boxes)))
    return c.reshape(1, -1, 8).contiguous(), tgeo.polygon_area(c)[None]


def _away_from_threshold(boxes, valid):
    """Invalidate the later box of every valid pair whose IoU is within
    IOU_MARGIN of THR, so that no kept/suppressed decision is marginal."""
    corners, area = _port_corners_area(boxes)
    iou = pairwise_iou_from_corners(corners, area)[0].numpy()
    valid = valid.copy()
    close = np.triu(np.abs(iou - THR) < IOU_MARGIN, 1)
    for i, j in zip(*np.nonzero(close)):
        if valid[i] and valid[j]:
            valid[j] = False
    live = np.triu(valid[:, None] & valid[None, :], 1)
    assert np.all(np.abs(iou - THR)[live] >= IOU_MARGIN)
    return valid


@jax.jit
def _xla_keep_jit(boxes, valid):
    iou = jnms._pairwise_rotated_iou_from_corners(jgeo.box_to_corners(boxes))
    return jnms._greedy_suppress(iou, valid, THR)


def _xla_keep(boxes, valid):
    """The reference XLA path: pairwise IoU, then the greedy fixpoint."""
    return np.asarray(_xla_keep_jit(jnp.asarray(boxes), jnp.asarray(valid)))


def _jax_keeps(boxes, valid):
    """(XLA keep, Pallas keep); the Pallas kernel runs in interpret mode.
    Its compile dominates this file's time, so the Pallas cases share one
    shape, K=200."""
    pal = pallas_keep(jnp.asarray(boxes), jnp.asarray(valid), THR,
                      interpret=True)
    return _xla_keep(boxes, valid), np.asarray(pal)


def test_corners_ccw_and_area_match_jax():
    boxes = _boxes(257, 0)
    jc = np.asarray(jgeo.box_to_corners(jnp.asarray(boxes)))
    tc = tgeo.box_to_corners(torch.from_numpy(boxes))
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=FLOAT_TOL)
    jccw = jgeo._ccw(jnp.asarray(jc))
    tccw = tgeo._ccw(torch.from_numpy(np.array(jc)))
    np.testing.assert_array_equal(tccw.numpy(), np.asarray(jccw))
    # winding: the doubled signed area of every CCW quad is non-negative
    area2 = tgeo._cross2(tccw[:, 0], tccw[:, 1], tccw[:, 2]) + tgeo._cross2(
        tccw[:, 0], tccw[:, 2], tccw[:, 3])
    assert bool((area2 >= 0).all())
    # shoelace area as nms_pallas.py computes it; its terms are products of
    # coordinates up to 40, whose fp32 rounding is ~1e-4 absolute
    nxt = jnp.roll(jccw, -1, axis=-2)
    jarea = 0.5 * jnp.abs((jccw[..., 0] * nxt[..., 1]
                           - nxt[..., 0] * jccw[..., 1]).sum(-1))
    tarea = tgeo.polygon_area(tccw).numpy()
    np.testing.assert_allclose(tarea, np.asarray(jarea), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tarea, boxes[:, 2] * boxes[:, 3], rtol=1e-4)


def test_intersection_area_matches_jax():
    boxes = _boxes(96, 1, spread=8.0)
    c = np.asarray(jgeo.box_to_corners(jnp.asarray(boxes)))
    ca = np.broadcast_to(c[:, None], (96, 96, 4, 2))
    cb = np.broadcast_to(c[None, :], (96, 96, 4, 2))
    ji = np.asarray(jgeo.rotated_intersection_area(jnp.asarray(ca),
                                                   jnp.asarray(cb)))
    ti = tgeo.rotated_intersection_area(torch.from_numpy(ca.copy()),
                                        torch.from_numpy(cb.copy()))
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=FLOAT_TOL)
    assert (ji > 0.1).sum() > 200          # the pairs really overlap


def test_pairwise_iou_matches_jax():
    boxes = _boxes(128, 2, spread=10.0)
    ji = np.asarray(jnms._pairwise_rotated_iou_from_corners(
        jgeo.box_to_corners(jnp.asarray(boxes))))
    corners, area = _port_corners_area(boxes)
    ti = pairwise_iou_from_corners(corners, area)[0].numpy()
    np.testing.assert_allclose(ti, ji, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("k,seed", [(200, 0), (333, 1)])
def test_keep_mask_equals_pallas_and_xla(k, seed):
    boxes = _boxes(k, seed)
    valid = np.ones((k,), bool)
    valid[-k // 10:] = False
    valid = _away_from_threshold(boxes, valid)
    corners, area = _port_corners_area(boxes)
    keep = rotated_nms_keep(corners, area, torch.from_numpy(valid[None]), THR)
    np.testing.assert_array_equal(keep[0].numpy(), _xla_keep(boxes, valid))
    if k == 200:
        _, pal = _jax_keeps(boxes, valid)
        np.testing.assert_array_equal(keep[0].numpy(), pal)
    assert 0 < keep.sum() < valid.sum()     # some boxes really suppressed


def test_keep_mask_batched_samples_are_independent():
    """One call over N samples gives each sample's own keep mask."""
    per = [_boxes(150, s) for s in (3, 4, 5)]
    valids = [_away_from_threshold(b, np.ones(150, bool)) for b in per]
    cs, areas = zip(*(_port_corners_area(b) for b in per))
    keep = rotated_nms_keep_ref(torch.cat(cs), torch.cat(areas),
                                torch.from_numpy(np.stack(valids)), THR)
    for i, (b, v) in enumerate(zip(per, valids)):
        np.testing.assert_array_equal(keep[i].numpy(), _xla_keep(b, v))


def test_keep_mask_all_invalid():
    boxes = _boxes(200, 6)
    corners, area = _port_corners_area(boxes)
    keep = rotated_nms_keep(corners, area, torch.zeros((1, 200), dtype=bool),
                            THR)
    assert not keep.any()
    xla, pal = _jax_keeps(boxes, np.zeros(200, bool))
    assert not xla.any() and not pal.any()


def test_keep_mask_duplicates_keep_exactly_one():
    boxes = np.tile(np.asarray([[3.0, -2.0, 1.6, 3.9, 0.7]], np.float32),
                    (200, 1))
    boxes[100:] = [20.0, 5.0, 2.0, 2.0, -1.2]        # a second stack
    valid = np.ones(200, bool)
    corners, area = _port_corners_area(boxes)
    keep = rotated_nms_keep(corners, area, torch.from_numpy(valid[None]),
                            THR)[0].numpy()
    xla, pal = _jax_keeps(boxes, valid)
    np.testing.assert_array_equal(keep, xla)
    np.testing.assert_array_equal(keep, pal)
    assert np.nonzero(keep)[0].tolist() == [0, 100]


def test_keep_mask_zero_size_boxes():
    """Zero-size boxes (w = l = 0, a third of them coincident) have IoU 0
    with each other, so none suppresses another.

    Their areas and clipped intersections are sums of products that cancel
    exactly only when every operation rounds on its own. The oracle is the
    reference path run op by op; compiled XLA code on the CPU (jit, and the
    Pallas kernel's interpret run) contracts products into FMAs, leaves
    residues and suppresses most of these points (ROADMAP, queue 3). The
    port rounds every operation, and its CUDA kernel is built with
    --fmad=false to do the same. A box of positive size against a point is
    left out: a point's clip polygon has no half-planes, so there even the
    op-by-op reference divides rounding residues."""
    boxes = _boxes(200, 7)
    boxes[:, 2:4] = 0.0
    boxes[::3, :2] = boxes[1::3, :2][:len(boxes[::3])]
    valid = np.ones(200, bool)
    corners, area = _port_corners_area(boxes)
    iou = pairwise_iou_from_corners(corners, area)
    assert bool(torch.isfinite(iou).all()) and float(iou.abs().max()) == 0.0
    keep = rotated_nms_keep(corners, area, torch.from_numpy(valid[None]),
                            THR)[0].numpy()
    with jax.disable_jit():
        ref = jnms._greedy_suppress(
            jnms._pairwise_rotated_iou_from_corners(
                jgeo.box_to_corners(jnp.asarray(boxes))),
            jnp.asarray(valid), THR)
    np.testing.assert_array_equal(keep, np.asarray(ref))
    assert keep.all()


@pytest.mark.parametrize("rotated", [True, False])
def test_nms_indices_match_jax(rotated):
    r = np.random.RandomState(11)
    n_samples, a = 3, 300
    rot = np.stack([_boxes(a, 20 + s, spread=25.0)
                    for s in range(n_samples)])
    scores = r.uniform(-0.5, 1.0, (n_samples, a)).astype(np.float32)
    scores[:, ::37] = -1.0                            # ties at the mask value
    if rotated:
        boxes = rot
        for s in range(n_samples):                   # no marginal IoU pairs
            order = np.argsort(-scores[s], kind="stable")
            v = _away_from_threshold(rot[s][order], scores[s][order] > 0)
            scores[s][order[~v]] = -1.0
    else:
        boxes = np.concatenate([rot[..., :2] - rot[..., 2:4] / 2,
                                rot[..., :2] + rot[..., 2:4] / 2], -1)
    kw = dict(pre_max_size=250, post_max_size=200, iou_threshold=THR,
              rotated=rotated)
    idx, valid = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          **kw)
    for s in range(n_samples):
        jidx, jvalid = jnms.nms(jnp.asarray(boxes[s]), jnp.asarray(scores[s]),
                                **kw)
        np.testing.assert_array_equal(valid[s].numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(idx[s].numpy(), np.asarray(jidx))
        assert 0 < int(valid[s].sum()) < 200


def test_box_decode_and_limit_period_match_jax():
    r = np.random.RandomState(5)
    enc = r.normal(0, 0.5, (2, 500, 7)).astype(np.float32)
    anchors = np.concatenate(
        [r.uniform(-20, 20, (2, 500, 3)), r.uniform(1, 4, (2, 500, 3)),
         r.uniform(-3, 3, (2, 500, 1))], -1).astype(np.float32)
    jd = np.asarray(jbox.second_box_decode(jnp.asarray(enc),
                                           jnp.asarray(anchors)))
    td = tbox.second_box_decode(torch.from_numpy(enc),
                                torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(td, jd, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    ang = r.uniform(-10, 10, 1000).astype(np.float32)
    np.testing.assert_allclose(
        tbox.limit_period(torch.from_numpy(ang)).numpy(),
        np.asarray(jbox.limit_period(jnp.asarray(ang))), rtol=0,
        atol=FLOAT_TOL)
    corners = tbox.center_to_corner_box2d(
        torch.from_numpy(anchors[0, :, :2]), torch.from_numpy(
            anchors[0, :, 3:5]), torch.from_numpy(anchors[0, :, 6]))
    np.testing.assert_allclose(
        tbox.corner_to_standup_nd(corners).numpy(),
        np.asarray(jbox.corner_to_standup_nd(jbox.center_to_corner_box2d(
            jnp.asarray(anchors[0, :, :2]), jnp.asarray(anchors[0, :, 3:5]),
            jnp.asarray(anchors[0, :, 6])))), rtol=0, atol=FLOAT_TOL)
