"""The port's network modules against the JAX package, on the CPU.

The small flagship stack of ``__graft_entry__._build_flagship(small=True)``
is initialised in JAX, its BatchNorm scales, biases and running statistics
and the head biases are replaced with random numbers (identity statistics
would hide a BatchNorm mapped to the wrong layer), and the weights go
through ``utils/convert.py::from_jax``. Each module then sees the same
inputs on both sides. fp32 on both sides; the sums run in different
orders, so outputs agree within rtol = atol = 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from __graft_entry__ import _build_flagship
from det3d_tpu.models.necks import RPN as JRPN
from det3d_tpu.parallel.train import build_example
from det3d_tpu.utils.synth import structured_batch
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.models.necks import RPN
from det3d_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
PC = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
SMALL = dict(voxel_size=(0.2, 0.2, 4.0), pc_range=PC, max_points=8,
             max_voxels=600)


def randomize(variables, seed):
    """Numpy copies of flax variables with random BN affine parameters,
    running statistics and conv biases (kernels keep their init)."""
    r = np.random.RandomState(seed)
    out = {}
    for col in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(variables[col])
        new = {}
        for path, v in flat.items():
            v = np.array(v, np.float32)
            leaf = path[-1]
            if leaf == "var":
                v = r.uniform(0.5, 2.0, v.shape)
            elif leaf in ("mean", "bias"):
                v = r.normal(0.0, 0.2, v.shape)
            elif leaf == "scale":
                v = r.uniform(0.5, 1.5, v.shape)
            new[path] = v.astype(np.float32)
        out[col] = traverse_util.unflatten_dict(new)
    return out


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks():
    """JAX small flagship with random weights, its per-module outputs on
    one structured batch, and the port's stack with the converted weights."""
    model, vg, _, _ = _build_flagship(small=True, **SMALL)
    batch = structured_batch(2, 2000, PC, seed=3)
    ex = build_example({k: jnp.asarray(v) for k, v in batch.items()}, vg,
                       [], [], with_targets=False)
    init = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), ex["voxels"], ex["num_points_per_voxel"],
        ex["coordinates"], train=False)
    var = randomize(init, 1)

    def sub(name):
        return {c: var[c][name] for c in ("params", "batch_stats")
                if name in var[c]}

    def run(module, *args, **kw):
        return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(*args)

    vox, npv, coords = (ex["voxels"], ex["num_points_per_voxel"],
                        ex["coordinates"])
    feats = run(model.reader, sub("reader"), vox, npv, coords, train=False)
    canvas = model.backbone.apply({}, feats, coords, model.grid_size)
    neck = run(model.neck, sub("neck"), canvas, train=False)
    head = run(model.bbox_head, sub("bbox_head"), neck, train=False)
    jax_out = dict(voxels=vox, num_points=npv, coords=coords, feats=feats,
                   canvas=canvas, neck=neck, head=head, var=var)

    tmodel = build_stack(flagship_config(small=True, **SMALL),
                         device="cpu")[0]
    tmodel.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                           strict=True)
    return to_np(jax_out), tmodel


def t(x):
    return torch.from_numpy(np.array(x))


def test_converter_covers_every_tensor(stacks):
    _, tmodel = stacks
    sd = tmodel.state_dict()
    assert len(sd) == 41
    # random statistics really arrived, in distinct layers
    means = [tuple(v[:3].tolist()) for k, v in sd.items()
             if k.endswith(".mean")]
    assert len(set(means)) == len(means) == 7


def test_pillar_feature_net(stacks):
    j, tmodel = stacks
    with torch.no_grad():
        out = tmodel.reader(t(j["voxels"]), t(j["num_points"]), t(j["coords"]))
    np.testing.assert_allclose(out.numpy(), j["feats"], **TOL)
    assert np.abs(j["feats"]).max() > 0.1


def test_pillar_scatter(stacks):
    j, tmodel = stacks
    with torch.no_grad():
        out = tmodel.backbone(t(j["feats"]), t(j["coords"]), tmodel.grid_size)
    assert out.shape == j["canvas"].shape          # (B, ny, nx, C)
    np.testing.assert_array_equal(out.numpy(), j["canvas"])


def test_rpn(stacks):
    j, tmodel = stacks
    with torch.no_grad():
        out = tmodel.neck(t(j["canvas"]))
    assert out.shape == j["neck"].shape
    np.testing.assert_allclose(out.numpy(), j["neck"], **TOL)


def test_head_forward(stacks):
    j, tmodel = stacks
    with torch.no_grad():
        out = tmodel.bbox_head(t(j["neck"]))
    assert len(out) == len(j["head"]) == 1
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        assert out[0][k].shape == j["head"][0][k].shape, k  # NHWC
        np.testing.assert_allclose(out[0][k].numpy(), j["head"][0][k],
                                   err_msg=k, **TOL)


def test_rpn_full_strides():
    """RPN with strided down convs and 2x and 4x transposed convs (the
    flagship's neck shape at a narrow width)."""
    kw = dict(layer_nums=[1, 2, 1], ds_layer_strides=[2, 2, 2],
              ds_num_filters=[8, 16, 16], us_layer_strides=[1, 2, 4],
              us_num_filters=[8, 8, 8], num_input_features=6)
    jrpn = JRPN(**kw)
    x = np.random.RandomState(4).normal(0, 1, (2, 16, 24, 6)).astype(
        np.float32)
    var = randomize(jax.jit(jrpn.init)(jax.random.PRNGKey(1),
                                       jnp.asarray(x)), 5)
    ref = np.asarray(jax.jit(jrpn.apply)(var, jnp.asarray(x)))
    rpn = RPN(**kw).eval()
    sd = {k[len("neck."):]: v for k, v in from_jax(
        {"neck": var["params"]}, {"neck": var["batch_stats"]}).items()}
    rpn.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = rpn(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 8, 12, 24)
    np.testing.assert_allclose(out, ref, **TOL)


# the small flagship's bf16 heads against JAX's bf16 heads, run op by op
# (apply outside jax.jit, whose XLA may skip a bf16 rounding between two
# ops): relative L2, measured 4.6e-4 on the CPU
SMALL_BF16_REL = 2e-3


def test_bf16_precision_raises(stacks):
    """The small flagship in bf16 builds, its heads stay within
    SMALL_BF16_REL of JAX's bf16 heads on the same weights and voxels and
    leave in fp32; a precision other than fp32 or bf16 still raises."""
    j, _ = stacks
    model = _build_flagship(small=True, precision="bf16", **SMALL)[0]
    var = j["var"]
    ref = model.apply(var, j["voxels"], j["num_points"], j["coords"],
                      train=False)
    tmodel = build_stack(flagship_config(small=True, precision="bf16",
                                         **SMALL), device="cpu")[0]
    tmodel.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                           strict=True)
    assert tmodel.neck.dtype == tmodel.reader.pfn_0.dtype == torch.bfloat16
    with torch.no_grad():
        out = tmodel(t(j["voxels"]), t(j["num_points"]), t(j["coords"]))
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        r = np.asarray(ref[0][k])
        assert out[0][k].dtype == torch.float32 and r.dtype == np.float32
        rel = np.linalg.norm(out[0][k].numpy() - r) / np.linalg.norm(r)
        assert rel < SMALL_BF16_REL, (k, rel)
    for precision in ("fp16", "int8"):
        cfg = flagship_config(small=True, precision=precision, **SMALL)
        with pytest.raises(NotImplementedError, match="precision"):
            build_stack(cfg, device="cpu")


@pytest.mark.parametrize("rotate", [True, False])
def test_head_predict_multi_task_multi_class(rotate):
    """Two tasks (1 and 2 classes, multi-class NMS), fed the same random
    head outputs: the port's predict gives JAX's detections. Covers the
    fused cross-task NMS, per-class offsets, the standup NMS branch, the
    direction fix, the range filter and the max_per_img cap."""
    from det3d_tpu.core.anchors import GroundBox3dCoder as JCoder
    from det3d_tpu.models.heads import MultiGroupHead as JHead
    from det3d_tpu_torch.core.anchors import GroundBox3dCoder
    from det3d_tpu_torch.models.heads import MultiGroupHead

    tasks = [dict(num_class=1, class_names=["Car"]),
             dict(num_class=2, class_names=["Pedestrian", "Cyclist"])]
    aux = dict(type="WeightedSoftmaxClassificationLoss",
               name="direction_classifier", loss_weight=0.2)
    jhead = JHead(in_channels=8, tasks=tasks, weights=[1, 1],
                  box_coder=JCoder(), loss_aux=aux)
    thead = MultiGroupHead(in_channels=8, tasks=tasks, weights=[1, 1],
                           box_coder=GroundBox3dCoder(), loss_aux=aux)
    test_cfg = dict(
        nms=dict(use_rotate_nms=rotate, use_multi_class_nms=True,
                 nms_pre_max_size=400, nms_post_max_size=40,
                 nms_iou_threshold=0.3),
        score_threshold=0.4,
        post_center_limit_range=[0.0, -10.0, -5.0, 18.0, 10.0, 5.0],
        max_per_img=60)
    r = np.random.RandomState(8)         # seed: scores clear of threshold
    b, h, w = 2, 10, 12
    preds, anchors = [], []
    for t in tasks:
        a_loc = 2 * t["num_class"]
        xy = np.stack(np.meshgrid(np.arange(w) * 1.6, np.arange(h) * 1.6 - 8,
                                  indexing="xy"), -1).reshape(-1, 1, 2)
        anc = np.zeros((h * w, a_loc, 7), np.float32)
        anc[..., :2] = xy
        anc[..., 2] = -1.0
        anc[..., 3:6] = [1.6, 3.9, 1.56]
        anc[..., 6] = np.tile([0.0, np.pi / 2], a_loc // 2)
        anchors.append(np.broadcast_to(anc.reshape(1, -1, 7),
                                       (b, h * w * a_loc, 7)).copy())
        preds.append(dict(
            box_preds=r.normal(0, 0.3, (b, h, w, a_loc * 7)),
            cls_preds=r.normal(-1.0, 1.5, (b, h, w, a_loc * t["num_class"])),
            dir_cls_preds=r.normal(0, 1, (b, h, w, a_loc * 2))))
    preds = [{k: v.astype(np.float32) for k, v in p.items()} for p in preds]
    for p in preds:                  # scores clear of the threshold
        s = 1 / (1 + np.exp(-p["cls_preds"].astype(np.float64)))
        assert np.abs(s - test_cfg["score_threshold"]).min() > 1e-4

    ref = jax.jit(lambda e, p: jhead.predict(e, p, test_cfg))(
        {"anchors": [jnp.asarray(a) for a in anchors]},
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])
    out = thead.predict({"anchors": [torch.from_numpy(a) for a in anchors]},
                        [{k: torch.from_numpy(v) for k, v in p.items()}
                         for p in preds], test_cfg)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert out["box3d_lidar"].shape == ref["box3d_lidar"].shape == (b, 60, 7)
    np.testing.assert_array_equal(out["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  ref["label_preds"])
    np.testing.assert_allclose(out["box3d_lidar"].numpy(),
                               ref["box3d_lidar"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"],
                               rtol=0, atol=1e-6)
    labels = ref["label_preds"][ref["valid"]]
    assert {0, 1, 2} <= set(labels.tolist())       # every class detected
    assert 0 < ref["valid"].sum(axis=1).min()
