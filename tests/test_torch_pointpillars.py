"""PointPillars as shipped: the port against the JAX package, on the CPU.

configs/nusc_pointpillars.py (bf16 reader and neck, appearance voxel
order, 5 point features, RPN ``[3, 5, 5]`` with the 0.5 branch, the 6-task
9-dim head at a quarter of the grid), configs/kitti_car_pointpillars.py
(bf16 reader and neck, hashed order, 100 points a pillar) and
configs/smoke_kitti_pointpillars.py (fp32, appearance order, a 100 x 100
grid):

- the three configs load through the port's ``Config`` without importing
  the JAX package (in a subprocess) and build with ``build_stack``;
- the appearance voxelizer, the port's device path and its numpy host
  twin, equals the JAX package's device path and its numpy twin, array
  for array, on clouds that overflow both caps, that fit, and that are
  empty;
- each bf16 layer (the pillar feature net, an RPN conv + BN, the 0.5
  branch's stride-2 conv, a transposed conv, a head's 1x1 convs) agrees
  with the JAX package's bf16 layer on the same inputs within a relative
  L2 of BF16_LAYER_REL, and each wrong rounding place reads above it;
- nuScenes PointPillars on a range cut to +-12.8 m and KITTI car on a
  25.6 x 25.6 m window, widths as shipped: in bf16 the heads lie within
  BF16_HEADS_REL of JAX's bf16 heads, and the port's post-processing of
  JAX's heads gives JAX's detections; in fp32 the whole predict step gives
  JAX's detections (equal valid masks and labels, boxes and scores within
  1e-4, every score clear of the cuts); the smoke config as shipped the
  same way;
- ``from_jax`` covers every tensor of both shipped models.

JAX's bf16 runs op by op (``apply`` outside ``jax.jit``): the rounding
places are those its code writes. Under ``jax.jit`` XLA may skip a bf16
rounding between two ops (it allows excess precision).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.core.voxelize import VoxelGenerator as JVoxelGenerator
from det3d_tpu.models import heads as jheads
from det3d_tpu.models import necks as jnecks
from det3d_tpu.models import readers as jreaders
from det3d_tpu.ops import sparse_host as jsph
from det3d_tpu.ops import voxelize_host as jvh
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models.heads import TaskHead
from det3d_tpu_torch.models.necks import RPN
from det3d_tpu_torch.models.readers import PillarFeatureNet
from det3d_tpu_torch.ops.voxelize_host import host_voxelize_batch
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_cbgs import random_variables
from tests.test_torch_modules import randomize

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {name: os.path.join(REPO, "configs", f"{name}.py") for name in
        ("nusc_pointpillars", "kitti_car_pointpillars",
         "smoke_kitti_pointpillars")}
# nuScenes: +-EXTENT m (128 x 128 pillars, a 32 x 32 head); KITTI car: x in
# [0, 2 EXTENT], y in +-EXTENT (160 x 160 pillars, an 80 x 80 head)
EXTENT = 12.8
CUT = {"nusc_pointpillars": (-EXTENT, -EXTENT, -5.0, EXTENT, EXTENT, 3.0),
       "kitti_car_pointpillars": (0.0, -EXTENT, -3.0, 2 * EXTENT, EXTENT,
                                  1.0)}
CUT_VOXELS = 2000
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16, relative L2 against the JAX package's bf16 (op by op) on the same
# inputs: one layer (measured at most 1.8e-6 on the CPU, a transposed conv
# whose fp32 sums run in another order and flip a few bf16 roundings; the
# wrong rounding places read 1.6e-3 and more), and the heads of the whole
# cut model (see test_bf16_heads_close_to_jax)
BF16_LAYER_REL = 1e-4
BF16_HEADS_REL = 5e-3
CLS_GAIN, CLS_BIAS = 5.0, -2.5          # the class convs of the predict tests
# the fp32 predict tests' weight seeds: the first from 2 up whose scores lie
# clear of the score threshold and the top-k cut on both sides (about one
# seed in thirty for nuScenes' 6 tasks of 2 x 20480 anchors)
FP32_SEEDS = {"nusc_pointpillars": 34, "kitti_car_pointpillars": 3,
              "smoke_kitti_pointpillars": 8}
# the predict tests' nms_pre_max_size (shipped: 1000, which chip_smoke runs
# on the card): the plain NMS twin computes the IoU of every pair on the CPU
PRE_MAX = 300


def load(name):
    cfg = Config.fromfile(CFGS[name])
    return {k: copy.deepcopy(cfg[k]) for k in
            ("tasks", "model", "assigner", "test_cfg", "voxel_generator")}


def cut_config(name, precision):
    """A shipped config over its cut range (CUT) and CUT_VOXELS pillars,
    every anchor generator and the post-center range over the same range,
    the reader and the neck in ``precision``; widths as shipped."""
    c = load(name)
    pc = list(CUT[name])
    c["voxel_generator"].update(range=pc, max_voxel_num=CUT_VOXELS)
    c["model"]["reader"].update(pc_range=pc, precision=precision)
    c["model"]["neck"]["precision"] = precision
    for g in c["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = pc[:2] + [z] + pc[3:5] + [z]
    c["test_cfg"]["post_center_limit_range"] = (
        [pc[0] - 5, pc[1] - 5, -10.0, pc[3] + 5, pc[4] + 5, 10.0])
    return c


def scans(name, b=2, points=6000, seed=3):
    """Structured scans over the config's range; nuScenes' with a fifth
    point feature (the sweep time) of zero, as bench.py feeds them."""
    c = load(name) if name not in CUT else cut_config(name, "fp32")
    d = structured_batch(b, points, c["voxel_generator"]["range"], seed=seed)
    if c["model"]["reader"].get("num_input_features", 4) == 5:
        d["points"] = np.concatenate(
            [d["points"], np.zeros_like(d["points"][..., :1])], -1)
    return d


def rel_l2(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def f32(x):
    """A JAX array (any float dtype) as a float32 numpy array."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and the appearance voxelizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CFGS))
def test_shipped_config_loads_and_builds_without_the_jax_package(name):
    """A fresh process (this one has imported the JAX package): the config
    loads and ``build_stack(cfg, device="cpu")`` builds it, bf16 where the
    config says so, with no det3d_tpu, jax or flax module imported."""
    code = (
        "import sys, torch\n"
        "from det3d_tpu_torch.apis.train import build_stack\n"
        "from det3d_tpu_torch.utils.config import Config\n"
        f"cfg = Config.fromfile({CFGS[name]!r})\n"
        "model, vg = build_stack(cfg, device='cpu')[:2]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('det3d_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
        "print(vg.order, model.reader.pfn_0.dtype, model.neck.dtype,\n"
        "      model.neck.block0_down_bn.dtype)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    dt = "torch.float32" if name.startswith("smoke") else "torch.bfloat16"
    order = "hashed" if name.startswith("kitti") else "appearance"
    assert res.stdout.split() == [order, dt, dt, dt]


def test_build_stack_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in CFGS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_stack(load(name))


VOX_KEYS = (("voxels", "voxels"), ("coords", "coordinates"),
            ("num_points_per_voxel", "num_points_per_voxel"),
            ("num_voxels", "num_voxels"))


@pytest.mark.parametrize("case", ["overflows", "fits", "empty"])
def test_appearance_voxelizer_equals_jax(case):
    """The port's device path (torch ops on the CPU here) and host twin
    against the JAX package's device path (VoxelGenerator.generate_batch)
    and its numpy twin (ops/voxelize_host.py::_appearance), at nuScenes
    PointPillars' 0.2 m pillars: exact equality, every output (integer
    and copy operations only)."""
    pc = CUT["nusc_pointpillars"]
    d = scans("nusc_pointpillars", points=6000)
    pts, n = d["points"], np.array([6000, 3500], np.int32)
    # overflows: 300 of ~2400 pillars kept and 4 points of up to ~60; fits
    # both caps; empty: no point
    v_cap, t_cap = {"overflows": (300, 4), "fits": (4096, 64),
                    "empty": (300, 4)}[case]
    if case == "empty":
        n = np.zeros(2, np.int32)
    kw = dict(voxel_size=(0.2, 0.2, 8.0), point_cloud_range=pc,
              max_num_points=t_cap, max_voxels=v_cap, order="appearance")
    ref = JVoxelGenerator(**kw).generate_batch(jnp.asarray(pts),
                                               jnp.asarray(n))
    vg = VoxelGenerator(**kw)
    dev = vg.generate_batch(torch.from_numpy(pts), torch.from_numpy(n))
    host = host_voxelize_batch(pts, n, vg)
    for k, hk in VOX_KEYS:
        r = np.asarray(ref[k])
        np.testing.assert_array_equal(dev[k].numpy(), r, err_msg=k)
        np.testing.assert_array_equal(host[hk], r, err_msg=k)
    for i in range(2):
        lin = jsph.point_lin(pts[i], n[i], kw["voxel_size"], pc, vg.grid_size)
        twin = jvh._appearance(pts[i].astype(np.float32), lin,
                               np.argsort(lin, kind="stable"),
                               *vg.grid_size[:2], v_cap, t_cap)
        for k, hk in VOX_KEYS:
            np.testing.assert_array_equal(host[hk][i], twin[k], err_msg=k)
    nv = host["num_voxels"]
    counts = host["num_points_per_voxel"]
    if case == "overflows":
        assert (nv == v_cap).all() and (counts == t_cap).sum() > 100
    elif case == "fits":
        assert (nv > 1000).all() and (nv < v_cap).all()
        assert counts.max() < t_cap
    else:
        assert (nv == 0).all() and (host["coordinates"] == -1).all()


# ---------------------------------------------------------------------------
# bf16 layers
# ---------------------------------------------------------------------------

def _pillars(r, b=2, v=96, t=20, c=5):
    """Random nuScenes-like pillars: points near their pillar's center,
    counts from 0 (empty rows) to t, zyx coords on the cut grid."""
    n = r.randint(0, t + 1, (b, v)).astype(np.int32)
    coords = np.zeros((b, v, 3), np.int32)
    coords[..., 1:] = r.randint(0, 128, (b, v, 2))
    centre = (coords[..., [2, 1]] + 0.5) * 0.2 - EXTENT
    pts = r.normal(0, 0.06, (b, v, t, c)).astype(np.float32)
    pts[..., :2] += centre[:, :, None]
    pts[..., 2] += -1.0
    pts *= (np.arange(t)[None, None, :] < n[..., None])[..., None]
    return pts, n, coords


def _layer_pair(layer, r):
    """(JAX module, its inputs, port module, its inputs) of one bf16 layer
    at nuScenes PointPillars' widths."""
    if layer == "pfn":
        kw = dict(num_input_features=5, num_filters=(64,),
                  voxel_size=(0.2, 0.2, 8.0),
                  pc_range=CUT["nusc_pointpillars"])
        pts, n, coords = _pillars(r)
        return (jreaders.PillarFeatureNet(precision="bf16", **kw),
                tuple(jnp.asarray(a) for a in (pts, n, coords)),
                PillarFeatureNet(precision="bf16", **kw),
                tuple(torch.from_numpy(a) for a in (pts, n, coords)))
    if layer == "head":
        x = np.maximum(r.normal(0, 1, (2, 8, 10, 384)), 0)
        xj = jnp.asarray(x, jnp.bfloat16)
        return (jheads.TaskHead(num_pred=36, num_cls=4), (xj,),
                TaskHead(384, 36, 4),
                (torch.from_numpy(f32(xj)).bfloat16().permute(0, 3, 1, 2),))
    # one RPN stage: a 3x3 conv + BN + ReLU at 64 channels, alone or with
    # the 0.5 branch (2x2 stride-2 conv) or a stride-4 transposed conv
    us = {"rpn_conv": [], "branch_half": [0.5], "deconv": [4]}[layer]
    kw = dict(layer_nums=[0], ds_layer_strides=[1], ds_num_filters=[64],
              us_layer_strides=us, us_num_filters=[128] * len(us),
              num_input_features=64)
    x = np.maximum(r.normal(0, 1, (2, 16, 12, 64)), 0)
    xj = jnp.asarray(x, jnp.bfloat16)
    return (jnecks.RPN(precision="bf16", **kw), (xj,),
            RPN(precision="bf16", **kw),
            (torch.from_numpy(f32(xj)).bfloat16(),))


def _run_layer(layer):
    """(JAX's bf16 output as fp32, the port's module with JAX's weights,
    its inputs); random weights, biases and BN statistics."""
    jl, jargs, port, targs = _layer_pair(layer, np.random.RandomState(0))
    var = randomize({"batch_stats": {},
                     **jl.init(jax.random.PRNGKey(0), *jargs)}, 1)
    ref = jl.apply(var, *jargs)
    if layer == "head":
        assert all(v.dtype == jnp.float32 for v in ref.values())
        ref = np.concatenate([f32(ref[k]) for k in ("box_preds",
                                                    "cls_preds")], -1)
    else:
        assert ref.dtype == jnp.bfloat16
        ref = f32(ref)
    # the RPN's BN names come from flax's call order under "neck"
    name = "neck" if isinstance(port, RPN) else "m"
    sd = from_jax({name: var["params"]}, {name: var["batch_stats"]})
    port.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                         strict=True)
    return ref, port.eval(), targs


def _port_out(layer, port, targs):
    with torch.no_grad():
        out = port(*targs)
    if layer == "head":
        assert all(v.dtype == torch.float32 for v in out.values())
        return torch.cat([out["box_preds"], out["cls_preds"]], -1).numpy()
    return out.float().numpy()


@pytest.mark.parametrize("layer", ["pfn", "rpn_conv", "branch_half",
                                   "deconv", "head"])
def test_layer_bf16_matches_jax(layer):
    """One bf16 layer, the same inputs and weights on both sides, within
    BF16_LAYER_REL relative L2. Each wrong rounding place reads above the
    limit: the pillar net's Dense in fp32 (rounded after BN, not after the
    product), its BN leaving fp32 (so the canvas would scatter in fp32);
    the RPN's convs on fp32 operands, its BNs leaving fp32; the head's
    bias added before its conv's rounding, or its convs in fp32."""
    ref, port, targs = _run_layer(layer)
    assert rel_l2(_port_out(layer, port, targs), ref) < BF16_LAYER_REL

    def wrong(obj, attr, value):
        old = getattr(obj, attr)
        setattr(obj, attr, value)
        try:
            return rel_l2(_port_out(layer, port, targs), ref)
        finally:
            setattr(obj, attr, old)

    f = torch.float32
    if layer == "pfn":
        errs = [wrong(port.pfn_0, "dtype", f),
                wrong(port.pfn_0.norm, "dtype", f)]
    elif layer == "head":
        x = targs[0]
        errs = [rel_l2(_port_out(layer, port, (x.float(),)), ref)]
        with torch.no_grad():
            fused = [torch.nn.functional.conv2d(
                x, c.weight.bfloat16(), c.bias.bfloat16()).float().permute(
                    0, 2, 3, 1) for c in (port.conv_box, port.conv_cls)]
        errs.append(rel_l2(torch.cat(fused, -1).numpy(), ref))
    else:
        bns = [m for m in port.modules() if hasattr(m, "mean")]
        errs = [wrong(port, "dtype", f)]
        for bn in bns:
            bn.dtype = f
        try:
            errs.append(rel_l2(_port_out(layer, port, targs), ref))
        finally:
            for bn in bns:
                bn.dtype = torch.bfloat16
    assert min(errs) > BF16_LAYER_REL, errs


# ---------------------------------------------------------------------------
# the cut models: bf16 heads, and the whole predict step in fp32
# ---------------------------------------------------------------------------

def _jax_stack(name, precision, batch, seed):
    """JAX's model of the config, random variables, its example (the
    device voxelizer) and its heads (op by op in bf16, jitted in fp32)."""
    c = cut_config(name, precision) if name in CUT else load(name)
    jmodel, vg, asg, cids, test_cfg = jbuild_stack(copy.deepcopy(c))
    ex = jbuild_example({k: jnp.asarray(v) for k, v in batch.items()}, vg,
                        asg, cids, with_targets=False)
    args = (ex["voxels"], ex["num_points_per_voxel"], ex["coordinates"])
    var = random_variables(jmodel.init, *args, seed=seed)
    for t in range(len(c["tasks"])):
        cls = var["params"]["bbox_head"][f"task_{t}"]["conv_cls"]
        cls["kernel"] = cls["kernel"] * CLS_GAIN
        cls["bias"] = np.full_like(cls["bias"], CLS_BIAS)
    if precision == "bf16":
        heads = jmodel.apply(var, *args, train=False)
    else:
        heads = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
            var, *args)
    test_cfg["nms"]["nms_pre_max_size"] = min(
        PRE_MAX, test_cfg["nms"]["nms_pre_max_size"])
    det = jax.jit(lambda e, h: jmodel.predict(e, h, test_cfg))(ex, heads)
    return c, var, ex, heads, det, test_cfg


def _port_stack(c, var, test_cfg):
    model, vg, asg, cids, _ = build_stack(copy.deepcopy(c), device="cpu")
    model.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                          strict=True)
    return model, vg, asg, cids


def _np_heads(heads):
    return [{k: np.asarray(v) for k, v in h.items()} for h in heads]


@pytest.fixture(scope="module", params=["nusc_pointpillars",
                                        "kitti_car_pointpillars"])
def bf16(request):
    """A cut shipped model in bf16 on both sides: JAX's heads and
    detections, the port's heads on the same voxels (its host twin)."""
    name = request.param
    batch = scans(name)
    c, var, ex, heads, det, test_cfg = _jax_stack(name, "bf16", batch, 4)
    model, vg, asg, _ = _port_stack(c, var, test_cfg)
    vox = host_plan_fn(model, vg, voxelize=True)(batch["points"],
                                                 batch["num_points"])
    for k in ("voxels", "coordinates", "num_points_per_voxel"):
        np.testing.assert_array_equal(vox[k], np.asarray(ex[k]), err_msg=k)
    with torch.no_grad():
        theads = model(*(torch.from_numpy(vox[k]) for k in
                         ("voxels", "num_points_per_voxel", "coordinates")))
    return dict(name=name, heads=_np_heads(heads), det=det, ex=ex,
                theads=[{k: v.numpy() for k, v in h.items()}
                        for h in theads], model=model, test_cfg=test_cfg)


def test_bf16_heads_close_to_jax(bf16):
    """Every task's heads within BF16_HEADS_REL relative L2 of JAX's bf16
    heads (measured on the CPU: nuScenes 3.61e-3, KITTI car 2.38e-3). A bf16
    rounding that one side flips and the other does not (their fp32 sums
    run in other orders) moves every layer after it, so the whole model
    reads above one layer's BF16_LAYER_REL."""
    for h, th in zip(bf16["heads"], bf16["theads"]):
        assert sorted(h) == sorted(th)
        for k in h:
            assert th[k].dtype == np.float32 and th[k].shape == h[k].shape
            assert rel_l2(th[k], h[k]) < BF16_HEADS_REL, (k, rel_l2(th[k],
                                                                     h[k]))


def test_bf16_post_processing_of_jax_heads_gives_jax_detections(bf16):
    """The port's decode + NMS fed JAX's bf16 heads (cast to fp32) gives
    JAX's detections: equal valid masks and labels, boxes and scores
    within 1e-4."""
    ex = bf16["ex"]
    example = {"anchors": [torch.from_numpy(np.asarray(a))
                           for a in ex["anchors"]]}
    out = bf16["model"].predict(
        example, [{k: torch.from_numpy(v) for k, v in h.items()}
                  for h in bf16["heads"]], bf16["test_cfg"])
    _assert_same_detections(out, bf16["det"])


def _assert_same_detections(out, det):
    det = {k: np.asarray(v) for k, v in det.items()}
    assert out["box3d_lidar"].shape == det["box3d_lidar"].shape
    np.testing.assert_array_equal(out["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)


@pytest.fixture(scope="module", params=["nusc_pointpillars",
                                        "kitti_car_pointpillars",
                                        "smoke_kitti_pointpillars"])
def fp32(request):
    """A shipped model in fp32 (the two bf16 configs cut, their reader and
    neck in fp32; the smoke config as shipped): JAX's heads and
    detections, and the port's heads and predict step on the same batch
    and weights, through the device voxelizer of the config's order."""
    name = request.param
    batch = scans(name, points=3000 if name.startswith("smoke") else 6000)
    c, var, ex, heads, det, test_cfg = _jax_stack(name, "fp32", batch,
                                                  FP32_SEEDS[name])
    model, vg, asg, cids = _port_stack(c, var, test_cfg)
    out = make_predict_step(model, vg, asg, cids, test_cfg)(batch)
    with torch.no_grad():
        theads = model(*(torch.from_numpy(np.asarray(ex[k])) for k in
                         ("voxels", "num_points_per_voxel", "coordinates")))
    return dict(name=name, heads=_np_heads(heads), det=det, out=out,
                theads=[{k: v.numpy() for k, v in h.items()}
                        for h in theads], test_cfg=test_cfg,
                var=var, model=model)


def _task_scores(head, num_class):
    """(B, A) top class scores of one task, in float64."""
    logits = head["cls_preds"].astype(np.float64).reshape(
        head["cls_preds"].shape[0], -1, num_class)
    return (1.0 / (1.0 + np.exp(-logits))).max(axis=-1)


def test_fp32_predict_step_matches_jax(fp32):
    """The whole predict step: equal valid masks and labels, boxes and
    scores within 1e-4; the heads within rtol = atol = 1e-4. No score lies
    closer to the score threshold or to the pre-NMS top-k cut than ten
    times the largest difference between the two sides' scores, so both
    select the same candidates."""
    test_cfg = fp32["test_cfg"]
    n_cls = [len(t["class_names"]) for t in fp32["model"].bbox_head.tasks]
    pairs = []
    for t, (h, th) in enumerate(zip(fp32["heads"], fp32["theads"])):
        for k in h:
            np.testing.assert_allclose(th[k], h[k], err_msg=k, **TOL)
        pairs.append((_task_scores(h, n_cls[t]), _task_scores(th, n_cls[t])))
    margin = 10 * max(np.abs(s - ts).max() for s, ts in pairs)
    assert margin < 1e-5
    k, thr = test_cfg["nms"]["nms_pre_max_size"], test_cfg["score_threshold"]
    for t, (scores, _) in enumerate(pairs):
        assert np.abs(scores - thr).min() > margin, t
        n_valid = (scores >= thr).sum(axis=1)
        assert (n_valid > 10).all(), (t, n_valid)
        srt = -np.sort(-scores, axis=1)
        assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > margin)).all()
    _assert_same_detections(fp32["out"], fp32["det"])
    if fp32["name"] == "nusc_pointpillars":
        det = np.asarray(fp32["det"]["label_preds"])
        assert len(np.unique(det[np.asarray(fp32["det"]["valid"])])) > 1


def test_converter_covers_every_tensor(fp32):
    """Every tensor of the model, and the RPN's BNs in flax's call order:
    nuScenes' 0.5 branch (a 2x2 stride-2 conv, HWIO -> OIHW) after stage
    0, KITTI's transposed convs flipped."""
    var, model = fp32["var"], fp32["model"]
    sd = from_jax(var["params"], var["batch_stats"])
    assert sorted(sd) == sorted(model.state_dict())
    neck = var["params"]["neck"]
    stats = var["batch_stats"]["neck"]
    n_bn = len(stats)
    assert n_bn == len([k for k in sd if k.startswith("neck.")
                        and k.endswith(".mean")])
    if fp32["name"] == "nusc_pointpillars":
        j = neck["deblock0_conv"]["kernel"]                 # (2, 2, 64, 128)
        w = sd["neck.deblock0_conv.weight"]
        assert j.shape == (2, 2, 64, 128) and w.shape == (128, 64, 2, 2)
        np.testing.assert_array_equal(w[7, 5, 1, 0].numpy(), j[1, 0, 5, 7])
        # stage 0's down conv and 3 convs, then its branch
        np.testing.assert_array_equal(sd["neck.deblock0_bn.mean"].numpy(),
                                      stats["MaskedBatchNorm_4"]["mean"])
    elif fp32["name"] == "kitti_car_pointpillars":
        j = neck["deblock2_deconv"]["kernel"]               # (4, 4, 256, 128)
        w = sd["neck.deblock2_deconv.weight"]
        assert w.shape == (256, 128, 4, 4)
        np.testing.assert_array_equal(w[9, 3, 0, 1].numpy(), j[3, 2, 9, 3])
    w = sd["reader.pfn_0.linear.weight"]
    j = var["params"]["reader"]["pfn_0"]["linear"]["kernel"]
    np.testing.assert_array_equal(w.numpy(), j.T)
