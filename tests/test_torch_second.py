"""SECOND serving from host plans: the port against the JAX package, on the
CPU.

The shipped configs/kitti_car_second.py, cut to a 16 x 16 m range with
``max_voxel_num`` 512 (the middle's and the RPN's widths stay full), on
structured scans:

- the port's host plan (ops/sparse_host.py::build_plan) and host voxels
  (ops/voxelize_host.py::host_voxelize) equal the JAX package's, array for
  array;
- ``SpMiddleFHD(plan=...)`` in fp32, with the JAX weights carried over by
  ``from_jax``, agrees within rtol = atol = 1e-4, with the dense tail and
  without;
- the whole predict step agrees with JAX's ``model.apply`` + ``predict``
  on the same host plans: the same valid masks and labels, boxes and
  scores within 1e-4;
- the bf16 middle against JAX's bf16 middle: relative L2 error 2.27e-3,
  held below 5e-3. That is the size of bf16 itself (JAX's bf16 middle is
  2.14e-3 from its fp32 one): a bf16 rounding that one side flips and the
  other does not spreads through the 14 layers, so the whole middle cannot
  tell where each side rounds;
- so each bf16 layer (sparse conv, dense conv, dense z conv) is also held
  against JAX's on the same inputs, where a wrong rounding place reads ten
  times and more above the limit.

The JAX middle runs with ``serve_band=None`` (the ``serve_*band`` keys are
dropped from its config): its plain window conv, not the interpret-mode
band kernel, which tests/test_torch_window_conv.py covers.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.models import backbones as jbb
from det3d_tpu.ops import sparse as jsp
from det3d_tpu.ops import sparse_host as jsph
from det3d_tpu.ops import voxelize_host as jvh
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.models.backbones import (DenseConvBN, SparseConvBN,
                                              middle_plan_spec)
from det3d_tpu_torch.ops import sparse_host as sph
from det3d_tpu_torch.ops import voxelize_host as vh
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_modules import randomize
from tests.test_torch_window_conv import subm_plan

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PC = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
# bf16, relative L2 against the JAX package's bf16: the whole middle
# (measured 2.27e-3 on the CPU, where JAX's own bf16 middle is 2.14e-3 from
# its fp32 middle) and one layer on the same inputs (measured at most
# 2.4e-5; see test_bf16_layer_matches_jax)
BF16_MIDDLE_REL = 5e-3
BF16_LAYER_REL = 1e-4
BANDS = ("serve_band", "serve_col_band", "serve_down_band",
         "serve_down_col_band")


def second_config(precision="fp32", dense_tail=True, jax_side=False):
    """configs/kitti_car_second.py over the PC range, 512 voxels."""
    cfg = Config.fromfile(os.path.join(REPO, "configs/kitti_car_second.py"))
    c = {k: copy.deepcopy(cfg[k]) for k in
         ("tasks", "model", "assigner", "test_cfg", "voxel_generator",
          "train_cfg")}
    c["voxel_generator"].update(range=list(PC), max_voxel_num=512)
    bb = c["model"]["backbone"]
    bb.update(serve_precision=precision, dense_tail=dense_tail)
    if jax_side:
        for k in BANDS:
            bb.pop(k)
    c["test_cfg"]["post_center_limit_range"] = [0, -8.0, -5.0, 16, 8.0, 5.0]
    c["assigner"]["target_assigner"]["anchor_generators"][0][
        "anchor_ranges"] = [0, -8.0, -1.0, 16, 8.0, -1.0]
    return c


def jax_plan(plan):
    return {k[5:]: jnp.asarray(v) for k, v in plan.items()
            if k.startswith("plan_")}


def torch_plan(plan):
    return {k[5:]: torch.from_numpy(v) for k, v in plan.items()
            if k.startswith("plan_")}


def jax_stack(precision, dense_tail, batch, seed=1):
    """JAX model with random weights and statistics, its host plan and
    example, and its numpy variables."""
    model, vg, asg, cids, test_cfg = jbuild_stack(
        second_config(precision, dense_tail, jax_side=True))
    plan = jhost_plan_fn(model, vg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    data = {k: jnp.asarray(v) for k, v in dict(batch, **plan).items()}
    ex = jbuild_example(data, vg, asg, cids, with_targets=False)
    init = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), ex["voxels"], ex["num_points_per_voxel"],
        ex["coordinates"], train=False, plan=jax_plan(plan))
    var = randomize(init, seed)
    return model, vg, asg, test_cfg, plan, ex, var


def torch_model(precision, dense_tail, var):
    model, vg, asg, cids, test_cfg = build_stack(
        second_config(precision, dense_tail), device="cpu")
    model.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                          strict=True)
    return model, vg, asg, cids, test_cfg


def run_middle(model, var, ex, plan):
    bb = {c: var[c]["backbone"] for c in ("params", "batch_stats")}
    return np.asarray(jax.jit(lambda v, x, c, p: model.backbone.apply(
        v, x, c, model.grid_size, train=False, plan=p))(
            bb, ex["voxels"], ex["coordinates"], jax_plan(plan)))


@pytest.fixture(scope="module")
def batch():
    return structured_batch(2, 3000, PC, seed=3)


# ---------------------------------------------------------------------------
# host plan and voxels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("points", [1500, 4000])
@pytest.mark.parametrize("order,pre_ranked,dense_tail", [
    ("yxz", True, True), ("hashed", False, False)])
def test_host_plan_and_voxels_equal_jax(seed, points, order, pre_ranked,
                                        dense_tail):
    b = structured_batch(1, points, PC, seed=seed)
    pts, n = b["points"][0], b["num_points"][0]
    spec = middle_plan_spec(dict(stage_caps=(1.0, 0.9, 0.8, 0.7),
                                 dense_tail=dense_tail, dense_from=3,
                                 pre_ranked=pre_ranked), (320, 320, 40), 512)
    kw = dict(voxel_size=(0.05, 0.05, 0.1), pc_range=PC,
              grid_size=(320, 320, 40), max_voxels=512, order=order,
              spec=spec)
    ours = sph.build_plan(pts, n, **kw)
    ref = jsph.build_plan(pts, n, train=False, **kw)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert (ours["plan_s0"] >> 24).any()
    vkw = dict(voxel_size=(0.05, 0.05, 0.1), pc_range=PC,
               grid_size=(320, 320, 40), max_voxels=512, max_points=5,
               order=order)
    for fuse_mean in (True, False):
        v_ours = vh.host_voxelize(pts, n, fuse_mean=fuse_mean, **vkw)
        v_ref = jvh.host_voxelize(pts, n, fuse_mean=fuse_mean, **vkw)
        for k in v_ref:
            np.testing.assert_array_equal(v_ours[k], v_ref[k], err_msg=k)


def test_host_plan_fn_equals_jax(batch):
    model, vg, _, _, _ = build_stack(second_config(), device="cpu")
    jmodel, jvg = jbuild_stack(second_config(jax_side=True))[:2]
    assert vg.effective_order == jvg.effective_order == "yxz"
    assert model.backbone.pre_ranked
    ours = host_plan_fn(model, vg, voxelize=True)(batch["points"],
                                                  batch["num_points"])
    ref = jhost_plan_fn(jmodel, jvg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the sparse middle and the whole predict step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense_tail", [True, False])
def test_middle_fp32_matches_jax(batch, dense_tail):
    jmodel, _, _, _, plan, ex, var = jax_stack("fp32", dense_tail, batch)
    ref = run_middle(jmodel, var, ex, plan)
    tmodel = torch_model("fp32", dense_tail, var)[0]
    with torch.no_grad():
        out = tmodel.backbone(torch.from_numpy(np.asarray(ex["voxels"])),
                              torch.from_numpy(np.asarray(
                                  ex["coordinates"])),
                              tmodel.grid_size, plan=torch_plan(plan))
    assert out.shape == ref.shape == (2, 40, 40, 128)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_converter_covers_every_tensor(batch):
    var = jax_stack("fp32", True, batch)[-1]
    sd = from_jax(var["params"], var["batch_stats"])
    tmodel = build_stack(second_config(), device="cpu")[0]
    assert sorted(sd) == sorted(tmodel.state_dict())
    assert len([k for k in sd if k.endswith(".norm.mean")]) == 14
    w = sd["backbone.DenseConvBN_3.weight"]
    assert w.shape == (64, 64, 3, 1, 1)
    j = var["params"]["backbone"]["DenseConvBN_3"]["kernel"]   # (3, I, O)
    np.testing.assert_array_equal(w[5, 7, :, 0, 0].numpy(), j[:, 7, 5])


def test_middle_bf16_close_to_jax_bf16(batch):
    jmodel, _, _, _, plan, ex, var = jax_stack("bf16", True, batch)
    ref = run_middle(jmodel, var, ex, plan).astype(np.float32)
    tmodel = torch_model("bf16", True, var)[0]
    with torch.no_grad():
        out = tmodel.backbone(torch.from_numpy(np.asarray(ex["voxels"])),
                              torch.from_numpy(np.asarray(
                                  ex["coordinates"])),
                              tmodel.grid_size, plan=torch_plan(plan))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < BF16_MIDDLE_REL, rel


def _layer_pair(layer, r):
    """One bf16 layer of the middle as (jax module, its init args, port
    module class and kwargs, inputs as numpy): the 16-channel submanifold
    sparse conv, a 64-channel 3x3x3 dense-tail conv, the (3, 1, 1) z conv."""
    if layer == "sparse":
        packed = subm_plan(3)
        x = r.randn(2, 96, 16).astype(np.float32)
        pres = np.stack([(packed >> (24 + j)) & 1 for j in range(3)],
                        -1).astype(bool)
        jargs = (jnp.asarray(x), jnp.asarray(packed & 0xFFFFFF),
                 jnp.asarray(pres), jnp.ones((2, 96), bool), False)
        return (jbb.SparseConvBN(16, precision="bf16"), jargs,
                dict(z_taps=jsp.center_column_taps(3)), SparseConvBN,
                (16, 16), {}, (torch.from_numpy(x),
                               torch.from_numpy(packed), True))
    kw, d_out = ({}, 5) if layer == "dense" else (
        dict(kernel=(3, 1, 1), stride=(2, 1, 1), padding=(0, 0, 0)), 2)
    occ_in = r.uniform(size=(2, 5, 12, 12)) < 0.3
    x = jnp.asarray(r.randn(2, 5, 12, 12, 64) * occ_in[..., None],
                    jnp.bfloat16)
    occ = r.uniform(size=(2, d_out, 12, 12)) < 0.5
    return (jbb.DenseConvBN(64, precision="bf16", **kw),
            (x, jnp.asarray(occ), False), {}, DenseConvBN, (64, 64), kw,
            (torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16(),
             torch.from_numpy(occ)))


@pytest.mark.parametrize("layer", ["sparse", "dense", "dense_z"])
def test_bf16_layer_matches_jax(layer):
    """One bf16 layer, the same inputs and weights on both sides: the port
    rounds where the JAX package does, so the outputs differ only where a
    sum in another fp32 order flips a bf16 rounding. Relative L2 measured
    (CPU): sparse 9.5e-8, dense 2.4e-5, dense_z 0; the limit is
    BF16_LAYER_REL. A wrong placement reads above 1e-3: the sparse conv
    with fp32 operands 1.4e-3 (or its fp32 output rounded to bf16 before
    BN, 1.0e-3), the dense convs with their BN epilogue in fp32 1.6e-3. The
    test holds the port's layer to the limit and the wrong variant above
    it."""
    jl, jargs, jkw, cls, chans, kw, targs = _layer_pair(
        layer, np.random.RandomState(0))
    var = randomize(jl.init(jax.random.PRNGKey(0), *jargs, **jkw), 1)
    ref = np.asarray(jl.apply(var, *jargs, **jkw)).astype(np.float32)
    name = f"{cls.__name__}_0"
    sd = from_jax({name: var["params"]}, {name: var["batch_stats"]})

    def rel(precision, fp32_epilogue=False):
        port = cls(*chans, precision=precision, **kw).eval()
        port.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                             strict=True)
        if fp32_epilogue:
            port.norm.dtype = torch.float32
        with torch.no_grad():
            out = port(*targs).float().numpy()
        return np.linalg.norm(out - ref) / np.linalg.norm(ref)

    assert rel("bf16") < BF16_LAYER_REL
    wrong = rel("fp32") if layer == "sparse" else rel("bf16", True)
    assert wrong > 10 * BF16_LAYER_REL, wrong


@pytest.fixture(scope="module")
def predict(batch):
    jmodel, vg, asg, test_cfg, plan, ex, var = jax_stack("fp32", True, batch,
                                                         seed=2)
    cls = var["params"]["bbox_head"]["task_0"]["conv_cls"]
    cls["kernel"] = cls["kernel"] * 20.0
    cls["bias"] = np.full_like(cls["bias"], 0.4)
    heads = jax.jit(lambda v, e, p: jmodel.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False, plan=p))(var, ex, jax_plan(plan))
    det = jax.jit(lambda e, h: jmodel.predict(e, h, test_cfg))(ex, heads)
    tmodel, tvg, tasg, tcids, ttest = torch_model("fp32", True, var)
    tplan = host_plan_fn(tmodel, tvg, voxelize=True)(batch["points"],
                                                     batch["num_points"])
    out = make_predict_step(tmodel, tvg, tasg, tcids, ttest)(
        dict(batch, **tplan))
    return (jax.tree_util.tree_map(np.asarray, heads),
            {k: np.asarray(v) for k, v in det.items()}, out, test_cfg)


def test_predict_scores_clear_of_the_cuts(predict):
    heads, _, _, test_cfg = predict
    scores = 1.0 / (1.0 + np.exp(-heads[0]["cls_preds"].astype(
        np.float64).reshape(2, -1)))
    assert np.abs(scores - test_cfg["score_threshold"]).min() > MARGIN
    n_valid = (scores >= test_cfg["score_threshold"]).sum(axis=1)
    assert (n_valid > 10).all()
    k = test_cfg["nms"]["nms_pre_max_size"]
    srt = -np.sort(-scores, axis=1)
    assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > MARGIN)).all()


def test_predict_step_matches_jax(predict):
    _, det, out, _ = predict
    assert out["box3d_lidar"].shape == det["box3d_lidar"].shape == (2, 100, 7)
    np.testing.assert_array_equal(out["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)


def test_predict_from_points_alone_matches_jax_plan_none(batch):
    """A batch of points alone: the device voxelizer (yxz order, fused
    mean) and the plan the middle builds on the device give JAX's
    ``plan=None`` detections, the middle computing in ``precision``
    (fp32) though the config serves bf16 from a host plan. Host voxels
    without a plan give the same detections as the points alone: their
    rows are the rows the device voxelizer emits."""
    jmodel, vg, asg, test_cfg, _, _, var = jax_stack("bf16", True, batch,
                                                     seed=2)
    cls = var["params"]["bbox_head"]["task_0"]["conv_cls"]
    cls["kernel"] = cls["kernel"] * 20.0
    cls["bias"] = np.full_like(cls["bias"], 0.4)
    cids = jbuild_stack(second_config("bf16", jax_side=True))[3]
    ex = jbuild_example({k: jnp.asarray(v) for k, v in batch.items()}, vg,
                        asg, cids, with_targets=False)
    heads = jax.jit(lambda v, e: jmodel.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False))(var, ex)
    scores = 1.0 / (1.0 + np.exp(-np.asarray(
        heads[0]["cls_preds"], np.float64).reshape(2, -1)))
    assert np.abs(scores - test_cfg["score_threshold"]).min() > MARGIN
    det = {k: np.asarray(v) for k, v in jax.jit(
        lambda e, h: jmodel.predict(e, h, test_cfg))(ex, heads).items()}

    model, tvg, tasg, tcids, ttest = torch_model("bf16", True, var)
    with torch.no_grad():
        mid = model.backbone(torch.from_numpy(np.asarray(ex["voxels"])),
                             torch.from_numpy(np.asarray(
                                 ex["coordinates"])), model.grid_size)
    assert mid.dtype == torch.float32
    step = make_predict_step(model, tvg, tasg, tcids, ttest)
    out = step(batch)
    np.testing.assert_array_equal(out["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)

    voxels = {k: v for k, v in host_plan_fn(model, tvg, voxelize=True)(
        batch["points"], batch["num_points"]).items()
        if not k.startswith("plan_")}
    from_voxels = step(dict(batch, **voxels))
    for k in out:
        assert torch.equal(from_voxels[k], out[k]), k


def test_build_stack_defaults_to_the_card(monkeypatch):
    """build_stack serves on the card unless asked for the CPU; without a
    card, asking for it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_stack(second_config())
    model = build_stack(second_config(), device="cpu")[0]
    assert next(model.parameters()).device.type == "cpu"
