"""KITTI 3-class SECOND serving from host plans: the port against the JAX
package, on the CPU.

The shipped configs/kitti_all_second.py (SpMiddleFHD with no
``serve_precision``, so the middle serves in fp32; yxz voxel order, rows
pre-ranked; 3 tasks, Car, Pedestrian and Cyclist, each with a direction
classifier; NMS at 0.01, ``max_per_img`` 100), cut to the 16 x 16 m range
and 512 voxels of tests/test_torch_second.py (every width stays full), on
structured scans:

- the shipped config loads through the port's ``Config`` without
  importing the JAX package (in a subprocess);
- the anchors of the 3 generators and the class ids of the 3 tasks equal
  the JAX package's at the shipped (1, 200, 176) feature map;
- the host plans and voxels equal the JAX package's, array for array;
- the fp32 middle (14 window convs on fp32 operands, 4 of them the dense
  tail's) agrees with JAX's within rtol = atol = 1e-4;
- the whole predict step agrees with JAX's ``model.apply`` + ``predict``:
  the three tasks' heads (box, class and direction) within 1e-4, the same
  valid masks and labels, boxes and scores within 1e-4, shape (B, 100, 7),
  every tensor carried over by ``from_jax``.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_lyft import (assert_scores_clear, fp32_middle,
                                   predict_pair)
from tests.test_torch_second import PC

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_ALL_CFG = os.path.join(REPO, "configs", "kitti_all_second.py")
TOL = dict(rtol=1e-4, atol=1e-4)
N_TASKS = 3
LAUNCHES = 14               # window convs of a forward (10 sparse, 4 of
                            # the tail), as on the card
# the class convs of test_predict_*: CAND_SHARE of the 3200 anchors a task
# and scan keeps most tasks under the shipped nms_pre_max_size of 1000
CLS_GAIN, CAND_SHARE = 5.0, 0.1


def kitti_all_config():
    """configs/kitti_all_second.py over tests/test_torch_second.py's PC
    range, 512 voxels; every anchor generator and the post-center range
    over the same range."""
    cfg = Config.fromfile(KITTI_ALL_CFG)
    c = {k: copy.deepcopy(cfg[k]) for k in
         ("tasks", "model", "assigner", "test_cfg", "voxel_generator",
          "train_cfg")}
    c["voxel_generator"].update(range=list(PC), max_voxel_num=512)
    c["test_cfg"]["post_center_limit_range"] = [0, -8.0, -5.0, 16, 8.0, 5.0]
    for g in c["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [PC[0], PC[1], z, PC[3], PC[4], z]
    return c


@pytest.fixture(scope="module")
def batch():
    return structured_batch(2, 3000, PC, seed=3)


# ---------------------------------------------------------------------------
# config, anchors, host data
# ---------------------------------------------------------------------------

def test_shipped_config_loads_without_the_jax_package():
    """The config imports only itertools and os; no det3d_tpu module is
    imported (a fresh process: this one has imported the JAX package)."""
    code = (
        "import sys\n"
        "from det3d_tpu_torch.utils.config import Config\n"
        f"cfg = Config.fromfile({KITTI_ALL_CFG!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('det3d_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
        "bb = cfg['model']['backbone']\n"
        "assert bb['type'] == 'SpMiddleFHD'\n"
        "assert 'serve_precision' not in bb\n"
        "assert cfg['voxel_generator']['order'] == 'yxz'\n"
        "assert len(cfg['tasks']) == 3\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_anchors_and_class_ids_equal_jax():
    """The shipped config: one generator per task at the (1, 200, 176)
    feature map, 2 rotations each."""
    cfg = Config.fromfile(KITTI_ALL_CFG)
    c = {k: copy.deepcopy(cfg[k]) for k in
         ("tasks", "model", "assigner", "test_cfg", "voxel_generator")}
    model, vg, asg, cids, _ = build_stack(c, device="cpu")
    _, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(c))
    assert vg.grid_size == jvg.grid_size == (1408, 1600, 40)
    assert cids == jcids == [[1], [2], [3]]
    assert len(asg) == len(jasg) == N_TASKS
    for a, ja in zip(asg, jasg):
        ours, ref = a.anchors_flat, np.asarray(ja.anchors_flat)
        assert ours.shape == (200 * 176 * 2, 7)
        np.testing.assert_array_equal(ours, ref)
    # no serve_precision: the middle serves in fp32; yxz rows come ranked
    assert model.backbone.dtype == torch.float32
    assert model.backbone.pre_ranked
    assert model.bbox_head.use_direction_classifier


def test_host_plan_fn_equals_jax(batch):
    model, vg = build_stack(kitti_all_config(), device="cpu")[:2]
    jmodel, jvg = jbuild_stack(kitti_all_config())[:2]
    assert vg.effective_order == jvg.effective_order == "yxz"
    ours = host_plan_fn(model, vg, voxelize=True)(batch["points"],
                                                  batch["num_points"])
    ref = jhost_plan_fn(jmodel, jvg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["voxels"].shape == (2, 512, 4)


# ---------------------------------------------------------------------------
# the fp32 middle and the whole predict step
# ---------------------------------------------------------------------------

def test_middle_fp32_matches_jax(batch, monkeypatch):
    """The shipped middle (fp32, dense tail from stage 3): 14 window convs,
    each on fp32 operands, and the output within 1e-4 of JAX's."""
    out, ref, calls = fp32_middle(kitti_all_config(), batch, monkeypatch)
    assert calls == [(torch.float32, torch.float32)] * LAUNCHES
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 40, 40, 128)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.fixture(scope="module")
def predict(batch):
    """tests/test_torch_lyft.py::predict_pair at the shipped
    nms_pre_max_size, 1000."""
    return predict_pair(kitti_all_config(), batch, CAND_SHARE)


def test_converter_covers_every_tensor(predict):
    var, tmodel = predict["var"], predict["tmodel"]
    sd = from_jax(var["params"], var["batch_stats"])
    assert sorted(sd) == sorted(tmodel.state_dict())
    assert len([k for k in sd if k.startswith("backbone.")
                and k.endswith(".norm.mean")]) == 14
    # 3 tasks, a box, a class and a direction conv each
    head = {k.split(".")[2] for k in sd if k.startswith("bbox_head.")}
    assert head == {"conv_box", "conv_cls", "conv_dir"}
    w = sd["bbox_head.task_2.conv_dir.weight"]
    j = var["params"]["bbox_head"]["task_2"]["conv_dir"]["kernel"]
    assert w.shape == (4, 128, 1, 1)
    np.testing.assert_array_equal(w[3, 7, 0, 0].numpy(), j[0, 0, 7, 3])


def test_predict_heads_match_jax(predict):
    assert len(predict["heads"]) == len(predict["theads"]) == N_TASKS
    for h, th in zip(predict["heads"], predict["theads"]):
        assert sorted(h) == sorted(th) == ["box_preds", "cls_preds",
                                           "dir_cls_preds"]
        for k in h:
            assert th[k].shape == h[k].shape
            np.testing.assert_allclose(th[k], h[k], **TOL)


def test_predict_scores_clear_of_the_cuts(predict):
    assert_scores_clear(predict)


def test_predict_step_matches_jax(predict):
    """max_per_img keeps the 100 best of the 3 tasks' 300 slots; every
    task's label among the valid detections."""
    det, out = predict["det"], predict["out"]
    assert out["box3d_lidar"].shape == det["box3d_lidar"].shape == (2, 100, 7)
    np.testing.assert_array_equal(out["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    assert sorted(np.unique(det["label_preds"][v])) == [0, 1, 2]
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)
