"""Visualization, the port against the JAX package on the CPU:
simplevis's BEV canvases equal to JAX's byte for byte, through cv2 and
through the numpy rasterizer (``_HAS_CV2`` off in both packages);
kitti_image's calibration, projections, ``compute_box_3d`` and drawings;
viewer3d's corners, PNG and PLY (bytes equal); netviz's totals and
top-level counts equal to JAX's for the small flagship (parameters only,
not BatchNorm statistics), its dot graph and its table.

Projections and corners agree within 1e-9 (float64; the port's box_np
multiplies the camera matrices in another order), everything else
exactly.
"""

import jax
import numpy as np
import pytest
from torch import nn

from __graft_entry__ import _build_flagship
from det3d_tpu.visualization import kitti_image as jki
from det3d_tpu.visualization import netviz as jnv
from det3d_tpu.visualization import simplevis as jsv
from det3d_tpu.visualization import viewer3d as jv3
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.visualization import kitti_image as ki
from det3d_tpu_torch.visualization import netviz as nv
from det3d_tpu_torch.visualization import simplevis as sv
from det3d_tpu_torch.visualization import viewer3d as v3
from tests.test_torch_modules import SMALL

CALIB = {
    "P2": np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                    [0, 0, 1, 0.003]]),
    "R0_rect": np.array([[0.9999, 0.0098, -0.0074], [-0.0099, 0.9999,
                                                     -0.0043],
                         [0.0074, 0.0044, 1.0]]),
    "Tr_velo_to_cam": np.array([[0.0075, -1.0, -0.0006, -0.0040],
                                [0.0148, 0.0007, -0.9999, -0.0763],
                                [0.9999, 0.0075, 0.0148, -0.2718]]),
}


def scene(rng, n=3000, boxes=5):
    pts = np.concatenate([rng.uniform([0, -40, -3], [70, 40, 1], (n, 3)),
                          rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    gt = np.concatenate([rng.uniform([5, -30, -1.5], [60, 30, -0.5],
                                     (boxes, 3)),
                         rng.uniform([1.5, 3.5, 1.4], [2, 4.5, 1.7],
                                     (boxes, 3)),
                         rng.uniform(-np.pi, np.pi, (boxes, 1))], 1)
    det = gt + rng.normal(0, 0.2, gt.shape)
    return pts, gt.astype(np.float32), det.astype(np.float32)


@pytest.mark.parametrize("cv2_on", [True, False])
def test_bev_canvases_equal(rng, monkeypatch, cv2_on):
    monkeypatch.setattr(sv, "_HAS_CV2", cv2_on)
    monkeypatch.setattr(jsv, "_HAS_CV2", cv2_on)
    pts, gt, det = scene(rng)
    ours = sv.kitti_vis(pts, gt, det)
    ref = jsv.kitti_vis(pts, gt, det)
    assert ours.shape == (800, 704, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    assert (ours == (0, 255, 0)).all(-1).any()
    assert (ours == (0, 128, 255)).all(-1).any()
    nus = sv.nuscene_vis(pts[:, :3] - [35, 0, 0], gt, det[:0])
    np.testing.assert_array_equal(
        nus, jsv.nuscene_vis(pts[:, :3] - [35, 0, 0], gt, det[:0]))


def test_numpy_rasterizer_draws_the_lines(rng, monkeypatch):
    """Without cv2 the numpy lines cover the cv2 lines' pixels but for
    their rounding: every pixel of one lies within a pixel of the other."""
    pts, gt, _ = scene(rng, n=0)
    canvases = []
    for on in (True, False):
        monkeypatch.setattr(sv, "_HAS_CV2", on)
        canvases.append(sv.kitti_vis(pts, gt).any(-1))
    a, b = (np.argwhere(c) for c in canvases)
    for p, q in ((a, b), (b, a)):
        d = np.abs(p[:, None] - q[None]).max(-1).min(1)
        assert d.max() <= 1


def test_calibration_and_projections(rng, tmp_path):
    calib, jcalib = ki.Calibration(CALIB), jki.Calibration(CALIB)
    text = "\n".join(f"{k}: " + " ".join(f"{v:.6e}" for v in np.ravel(a))
                     for k, a in CALIB.items())
    (tmp_path / "000001.txt").write_text(text + "\nP0: 1 0 0 0\n")
    from_file = ki.Calibration(tmp_path / "000001.txt")
    for m in ("P", "V2C", "R0"):
        np.testing.assert_array_equal(getattr(from_file, m),
                                      getattr(jki.Calibration(
                                          tmp_path / "000001.txt"), m))
        np.testing.assert_allclose(getattr(from_file, m),
                                   getattr(calib, m), atol=1e-9)
    pts = rng.uniform([5, -20, -2], [60, 20, 1], (50, 3))
    for fn in ("project_velo_to_rect", "project_velo_to_image"):
        np.testing.assert_allclose(getattr(calib, fn)(pts),
                                   getattr(jcalib, fn)(pts), rtol=1e-9,
                                   atol=1e-9)
    rect = calib.project_velo_to_rect(pts)
    np.testing.assert_allclose(calib.project_rect_to_image(rect),
                               jcalib.project_rect_to_image(rect),
                               rtol=1e-9, atol=1e-9)


def test_compute_box_3d_and_drawings(rng):
    calib, jcalib = ki.Calibration(CALIB), jki.Calibration(CALIB)
    _, gt, _ = scene(rng)
    cam = ki.lidar_boxes_to_kitti_camera(gt, calib)
    for box in cam:
        c2d, c3d = ki.compute_box_3d(box, calib)
        r2d, r3d = jki.compute_box_3d(box, jcalib)
        np.testing.assert_array_equal(c3d, r3d)
        if r2d is None:
            assert c2d is None
        else:
            np.testing.assert_allclose(c2d, r2d, rtol=1e-9, atol=1e-9)
    behind = np.array([0.0, 1.0, -5.0, 1.5, 1.6, 4.0, 0.0])
    assert ki.compute_box_3d(behind, calib)[0] is None
    img = rng.randint(0, 255, (375, 1242, 3)).astype(np.uint8)
    labels, scores = ["Car"] * len(gt), np.linspace(0.2, 0.9, len(gt))
    ours = ki.show_lidar_boxes_on_image(img, gt, calib, labels=labels,
                                        scores=scores)
    ref = jki.show_lidar_boxes_on_image(img, gt, jcalib, labels=labels,
                                        scores=scores)
    np.testing.assert_array_equal(ours, ref)
    assert (ours != img).any()
    box2d = [100.4, 50.6, 300.2, 200.9]
    np.testing.assert_array_equal(
        ki.draw_box2d(img.copy(), box2d, label="Car"),
        jki.draw_box2d(img.copy(), box2d, label="Car"))


def test_viewer3d_corners_ply_and_png(rng, tmp_path):
    pts, gt, det = scene(rng, n=500, boxes=3)
    np.testing.assert_allclose(v3.box_corners_3d(gt), jv3.box_corners_3d(gt),
                               rtol=1e-9, atol=1e-9)
    for kw in (dict(gt_boxes=gt, det_boxes=det), dict(intensity=None),
               dict(gt_boxes=gt[:0])):
        v3.export_ply(tmp_path / "ours.ply", pts, **kw)
        jv3.export_ply(tmp_path / "ref.ply", pts, **kw)
        assert ((tmp_path / "ours.ply").read_bytes()
                == (tmp_path / "ref.ply").read_bytes())
    v3.export_ply(tmp_path / "xyz.ply", pts[:, :3], gt_boxes=gt)
    text = (tmp_path / "xyz.ply").read_text()
    assert f"element vertex {500 + 24}" in text and "element edge 36" in text
    v3.show_pointcloud(pts, gt_boxes=gt, det_boxes=det,
                       save=str(tmp_path / "scene.png"))
    assert (tmp_path / "scene.png").stat().st_size > 1000


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 5)
        self.Dense_1 = nn.Linear(5, 3)


def test_netviz_tiny(tmp_path):
    """The JAX test's two-Dense model: 4*5+5 + 5*3+3 = 43 parameters."""
    dot = nv.to_dot(Tiny(), "tiny")
    assert dot.startswith('digraph "tiny"')
    assert '"Dense_0" [label="Dense_0\\nweight(5, 4), bias(5,)"]' in dot
    assert '"tiny" -> "Dense_1"' in dot
    written = nv.render(Tiny(), str(tmp_path / "g"), "tiny")
    assert (tmp_path / "g.dot").read_text() == dot and written
    table = nv.summarize(Tiny())
    assert table.splitlines()[-1].split() == ["total", "43"]


def test_netviz_flagship_counts_equal_jax():
    model = build_stack(flagship_config(small=True, **SMALL),
                        device="cpu")[0]
    jm, jvg = _build_flagship(small=True, **SMALL)[:2]
    b, v, t_ = 1, 64, jvg.max_num_points
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((b, v, t_, 4)),
        jax.numpy.zeros((b, v), jax.numpy.int32),
        jax.numpy.zeros((b, v, 4), jax.numpy.int32), train=False))
    params = shapes["params"]
    ours, ref = nv.summarize(model), jnv.summarize(params)
    assert ours == ref
    total = sum(p.numel() for p in model.parameters())
    assert ours.splitlines()[-1].split() == ["total", f"{total:,}"]
    assert sum(b.numel() for b in model.buffers()) > 0   # not counted
    nodes, edges = nv.module_graph(model, "flagship")
    jnodes, jedges = jnv.module_graph(params, "flagship")
    assert nodes[0] == jnodes[0] and len(edges) == len(nodes) - 1
    top = {p: lbl for p, lbl in nodes if p and "/" not in p}
    jtop = {p: lbl for p, lbl in jnodes if p and "/" not in p}
    assert top == jtop and set(top) == {"reader", "neck", "bbox_head"}


def test_package_exports():
    from det3d_tpu_torch import visualization
    assert visualization.kitti_vis is sv.kitti_vis
    assert set(visualization.__all__) == {
        "bev_canvas", "draw_points_bev", "draw_boxes_bev", "kitti_vis",
        "nuscene_vis"}
