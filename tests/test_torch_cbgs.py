"""CBGS nuScenes serving from host plans: the port against the JAX package,
on the CPU.

The shipped configs/nusc_cbgs_voxelnet.py, cut to a +-12.8 m range with
``max_voxel_num`` 1024 (the middle's, the RPN's and the 6-task head's
widths stay full: 0.1 x 0.1 x 0.2 m voxels, 5 point features,
SpMiddleResNetFHD with ``dense_from=2``, the 9-dim velocity coder with
vector angles, the fused cross-task NMS), on structured scans:

- the shipped config loads through the port's ``Config`` without
  importing the JAX package (in a subprocess), and the port's nuScenes
  presets equal the JAX package's;
- ``order="appearance"`` with the fused mean voxelizes in hashed order;
- the host plans and voxels equal the JAX package's, array for array, and
  so do the anchors of the 6 tasks at the shipped feature map;
- each residual layer (SparseBasicBlock, DenseBasicBlock, and a biased
  SparseConvBN / DenseConvBN without ReLU) agrees in fp32 within rtol =
  atol = 1e-4 and in bf16 within a relative L2 of 1e-4;
- ``SpMiddleResNetFHD(plan=...)`` in fp32 agrees within 1e-4 at
  ``dense_from`` 2 and 3 and without the dense tail, and in bf16 within a
  relative L2 of 5e-3 of JAX's bf16 middle;
- the whole predict step agrees with JAX's ``model.apply`` + ``predict``:
  the same valid masks and labels, boxes and scores within 1e-4, shape
  (B, 6 x 83, 9).

The JAX middle runs with the ``serve_*band`` keys dropped (its plain window
conv), as tests/test_torch_second.py explains.
"""

import copy
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.config_presets import nusc as jnusc
from det3d_tpu.core.voxelize import VoxelGenerator as JVoxelGenerator
from det3d_tpu.models import backbones as jbb
from det3d_tpu.ops import sparse as jsp
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.config_presets import nusc
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models.backbones import (DenseBasicBlock, DenseConvBN,
                                              SparseBasicBlock,
                                              SparseConvBN)
from det3d_tpu_torch.models.necks import stage_conv
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_modules import randomize
from tests.test_torch_second import BANDS, jax_plan, torch_plan
from tests.test_torch_window_conv import subm_plan

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBGS_CFG = os.path.join(REPO, "configs", "nusc_cbgs_voxelnet.py")
EXTENT = 12.8
PC = (-EXTENT, -EXTENT, -5.0, EXTENT, EXTENT, 3.0)
TOL = dict(rtol=1e-4, atol=1e-4)
# bf16, relative L2 against the JAX package's bf16: the whole middle
# (measured 3.90e-3 on the CPU, where JAX's own bf16 middle is 3.52e-3 from
# its fp32 middle) and one layer on the same inputs (measured at most
# 3.1e-8; see test_layer_bf16_matches_jax)
BF16_MIDDLE_REL = 5e-3
BF16_LAYER_REL = 1e-4
N_TASKS, POST_MAX = 6, 83
CLS_GAIN, CLS_BIAS = 5.0, -2.5          # the class convs of test_predict_*
# the predict tests' nms_pre_max_size (shipped: 1000, which chip_smoke runs
# on the card): the plain NMS twin computes the IoU of every pair on the
# CPU, ~16 s here for the fused 12 samples at K=1000
PRE_MAX = 300


def cbgs_config(precision="fp32", dense_from=2, dense_tail=True,
                jax_side=False):
    """configs/nusc_cbgs_voxelnet.py over the +-12.8 m range, 1024 voxels,
    every anchor generator over the same range."""
    cfg = Config.fromfile(CBGS_CFG)
    c = {k: copy.deepcopy(cfg[k]) for k in
         ("tasks", "model", "assigner", "test_cfg", "voxel_generator",
          "train_cfg")}
    c["voxel_generator"].update(range=list(PC), max_voxel_num=1024)
    bb = c["model"]["backbone"]
    bb.update(serve_precision=precision, dense_from=dense_from,
              dense_tail=dense_tail)
    if jax_side:
        for k in BANDS:
            bb.pop(k)
    for g in c["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [-EXTENT, -EXTENT, z, EXTENT, EXTENT, z]
    return c


def cbgs_batch(b, points, seed):
    """Structured scans with nuScenes' 5 point features (the fifth, the
    sweep time, zero), as bench.py feeds CBGS."""
    d = structured_batch(b, points, PC, seed=seed)
    p = d["points"]
    d["points"] = np.concatenate([p, np.zeros_like(p[..., :1])], -1)
    return d


@pytest.fixture(scope="module")
def batch():
    return cbgs_batch(2, 3000, seed=3)


def jax_example(model, vg, asg, cids, batch):
    plan = jhost_plan_fn(model, vg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    data = {k: jnp.asarray(v) for k, v in dict(batch, **plan).items()}
    return plan, jbuild_example(data, vg, asg, cids, with_targets=False)


def random_variables(init_fn, *args, seed, **kw):
    """Random flax variables of the shapes ``init_fn(..., train=False)``
    gives, found by tracing it (no compile, no run): kernels uniform in
    +-sqrt(3 / fan_in), as flax's default init draws them, and the BN
    statistics, scales and the biases as ``randomize`` draws them."""
    shapes = jax.eval_shape(functools.partial(init_fn, train=False),
                            jax.random.PRNGKey(0), *args, **kw)
    r = np.random.RandomState(seed)

    def draw(path, s):
        if path[-1].key != "kernel":
            return np.zeros(s.shape, np.float32)
        bound = np.sqrt(3.0 / np.prod(s.shape[:-1]))
        return r.uniform(-bound, bound, s.shape).astype(np.float32)
    return randomize(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def jax_middle(precision, dense_from, dense_tail, batch, seed=1):
    """The JAX middle's output on ``batch`` with random weights and
    statistics, its numpy variables, and the inputs it was fed."""
    model, vg, asg, cids, _ = jbuild_stack(
        cbgs_config(precision, dense_from, dense_tail, jax_side=True))
    plan, ex = jax_example(model, vg, asg, cids, batch)
    var = random_variables(
        functools.partial(model.backbone.init, input_shape=model.grid_size),
        ex["voxels"], ex["coordinates"], seed=seed, plan=jax_plan(plan))
    feats = model.reader.apply({}, ex["voxels"], ex["num_points_per_voxel"])
    out = jax.jit(lambda v, x, c, p: model.backbone.apply(
        v, x, c, model.grid_size, train=False, plan=p))(
            var, feats, ex["coordinates"], jax_plan(plan))
    return np.asarray(out).astype(np.float32), var, feats, ex, plan


def port_middle(precision, dense_from, dense_tail, var, feats, ex, plan):
    model = build_stack(cbgs_config(precision, dense_from, dense_tail),
                        device="cpu")[0]
    sd = from_jax({"backbone": var["params"]},
                  {"backbone": var["batch_stats"]})
    model.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        return model.backbone(torch.from_numpy(np.asarray(feats)),
                              torch.from_numpy(np.asarray(
                                  ex["coordinates"])),
                              model.grid_size, plan=torch_plan(plan))


# ---------------------------------------------------------------------------
# config, presets, voxelizer, host data, anchors
# ---------------------------------------------------------------------------

def test_shipped_config_loads_without_the_jax_package():
    """The config's ``from det3d_tpu.config_presets.nusc import ...``
    resolves to the port's copy; no det3d_tpu module is imported (a fresh
    process: this one has imported the JAX package)."""
    code = (
        "import sys\n"
        "from det3d_tpu_torch.utils.config import Config\n"
        f"cfg = Config.fromfile({CBGS_CFG!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('det3d_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
        "assert cfg['model']['backbone']['type'] == 'SpMiddleResNetFHD'\n"
        "assert len(cfg['tasks']) == 6\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_config_importing_other_jax_modules_raises(tmp_path):
    path = tmp_path / "bad_cfg.py"
    path.write_text("from det3d_tpu.models import backbones\nx = 1\n")
    with pytest.raises(ImportError, match="imports nothing of det3d_tpu"):
        Config.fromfile(path)


def test_presets_equal_jax():
    assert nusc.nusc_tasks() == jnusc.nusc_tasks()
    assert nusc._ANCHORS == jnusc._ANCHORS
    for extent in (51.2, EXTENT):
        assert (nusc.nusc_anchor_generators(extent)
                == jnusc.nusc_anchor_generators(extent))
    assert (nusc.nusc_db_sampler("x.pkl", True)
            == jnusc.nusc_db_sampler("x.pkl", True))


def test_appearance_order_with_fused_mean_is_hashed():
    kw = dict(voxel_size=(0.1, 0.1, 0.2), point_cloud_range=PC,
              max_num_points=10, max_voxels=1024, order="appearance")
    ours = VoxelGenerator(fuse_mean=True, **kw)
    assert (ours.effective_order
            == JVoxelGenerator(fuse_mean=True, **kw).effective_order
            == "hashed")
    assert ours.host_kwargs()["order"] == "appearance"
    # without the fused mean the order is appearance itself
    assert (VoxelGenerator(fuse_mean=False, **kw).effective_order
            == JVoxelGenerator(fuse_mean=False, **kw).effective_order
            == "appearance")
    model, vg = build_stack(cbgs_config(), device="cpu")[:2]
    assert vg.order == "appearance" and vg.fuse_mean
    assert not model.backbone.pre_ranked


@pytest.mark.parametrize("dense_from,dense_tail", [(2, True), (3, True),
                                                   (2, False)])
def test_host_plan_fn_equals_jax(batch, dense_from, dense_tail):
    model, vg = build_stack(cbgs_config("fp32", dense_from, dense_tail),
                            device="cpu")[:2]
    jmodel, jvg = jbuild_stack(cbgs_config("fp32", dense_from, dense_tail,
                                           jax_side=True))[:2]
    ours = host_plan_fn(model, vg, voxelize=True)(batch["points"],
                                                  batch["num_points"])
    ref = jhost_plan_fn(jmodel, jvg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    n_stages = 4 if not dense_tail else dense_from
    assert sorted(k for k in ours if k.startswith("plan_down")) == [
        f"plan_down{i}" for i in range(1, n_stages + 1)]
    assert ours["voxels"].shape == (2, 1024, 5)
    assert (ours["num_voxels"] > 500).all()


def test_anchors_and_class_ids_equal_jax():
    """The shipped config: 10 generators with velocities over 6 tasks, at
    the (1, 128, 128) feature map."""
    cfg = Config.fromfile(CBGS_CFG)
    c = {k: cfg[k] for k in ("tasks", "model", "assigner", "test_cfg",
                             "voxel_generator")}
    _, vg, asg, cids, _ = build_stack(c, device="cpu")
    _, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(c))
    assert vg.grid_size == jvg.grid_size == (1024, 1024, 40)
    assert cids == jcids == [[1], [2, 3], [4, 5], [6], [7, 8], [9, 10]]
    assert len(asg) == len(jasg) == N_TASKS
    for a, ja in zip(asg, jasg):
        ours, ref = a.anchors_flat, np.asarray(ja.anchors_flat)
        assert ours.shape == ref.shape
        assert ours.shape == (128 * 128 * 2 * len(a.anchor_generators), 9)
        np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_pair(layer, precision, r):
    """One layer of the CBGS middle as (jax module, its call args, port
    module, port call args): a SparseBasicBlock or a biased SparseConvBN
    without ReLU (16 channels, a submanifold rulebook), a DenseBasicBlock
    or a biased DenseConvBN without ReLU (64 channels, NDHWC)."""
    if layer.startswith("sparse"):
        packed = subm_plan(3)
        x = r.randn(2, 96, 16).astype(np.float32)
        if layer == "sparse_block":
            x = np.maximum(x, 0)                     # a ReLU's output
        pres = np.stack([(packed >> (24 + j)) & 1 for j in range(3)],
                        -1).astype(bool)
        jargs = (jnp.asarray(x), jnp.asarray(packed & 0xFFFFFF),
                 jnp.asarray(pres), jnp.ones((2, 96), bool), False)
        targs = (torch.from_numpy(x), torch.from_numpy(packed))
        if layer == "sparse_block":
            return (jbb.SparseBasicBlock(16, precision=precision), jargs, {},
                    SparseBasicBlock(16, precision=precision), targs)
        return (jbb.SparseConvBN(16, use_bias=True, relu=False,
                                 precision=precision), jargs,
                dict(z_taps=jsp.center_column_taps(3)),
                SparseConvBN(16, 16, precision=precision, use_bias=True,
                             relu=False), targs + (True,))
    occ = r.uniform(size=(2, 5, 12, 12)) < 0.3
    x = np.maximum(r.randn(2, 5, 12, 12, 64), 0) * occ[..., None]
    dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
    xj = jnp.asarray(x, dt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    if precision == "bf16":
        xt = xt.bfloat16()
    jargs, targs = (xj, jnp.asarray(occ), False), (xt, torch.from_numpy(occ))
    if layer == "dense_block":
        return (jbb.DenseBasicBlock(64, precision=precision), jargs, {},
                DenseBasicBlock(64, precision=precision), targs)
    return (jbb.DenseConvBN(64, use_bias=True, relu=False,
                            precision=precision), jargs, {},
            DenseConvBN(64, 64, precision=precision, use_bias=True,
                        relu=False), targs)


def _run_layer(layer, precision):
    """(JAX output, port module with JAX's weights, port args) of one layer
    at ``precision``, random weights, biases and statistics."""
    jl, jargs, jkw, port, targs = _layer_pair(layer, precision,
                                              np.random.RandomState(0))
    var = randomize(jl.init(jax.random.PRNGKey(0), *jargs, **jkw), 1)
    ref = np.asarray(jl.apply(var, *jargs, **jkw)).astype(np.float32)
    name = f"{type(port).__name__}_0"
    sd = from_jax({name: var["params"]}, {name: var["batch_stats"]})
    port.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()},
                         strict=True)
    return ref, port.eval(), targs


LAYERS = ["sparse_block", "sparse_conv_bias", "dense_block",
          "dense_conv_bias"]


@pytest.mark.parametrize("layer", LAYERS)
def test_layer_fp32_matches_jax(layer):
    ref, port, targs = _run_layer(layer, "fp32")
    with torch.no_grad():
        out = port(*targs)
    assert out.dtype == torch.float32
    assert (ref < 0).any() == layer.endswith("bias")     # ReLU or not
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("layer", ["sparse_block", "dense_block"])
def test_layer_bf16_matches_jax(layer):
    """A bf16 residual block, the same inputs and weights on both sides,
    within BF16_LAYER_REL relative L2 (measured on the CPU: sparse 3.1e-8,
    dense 5.0e-9). Each wrong rounding place reads above the limit: the
    sparse block with fp32 conv operands 1.8e-4 (its fp32 residual input
    dilutes the error) or with its BN outputs rounded to bf16 6.8e-4; the
    dense block with its BN epilogues in fp32 (the residual add then
    leaves fp32 too) 1.9e-3."""
    ref, port, targs = _run_layer(layer, "bf16")
    convs = list(port.children())

    def rel(**attrs):
        for conv in convs:
            for path, value in attrs.items():
                obj = conv.norm if path == "norm_dtype" else conv
                obj.dtype = value
        with torch.no_grad():
            out = port(*targs).float().numpy()
        return np.linalg.norm(out - ref) / np.linalg.norm(ref)

    assert rel() < BF16_LAYER_REL
    if layer == "sparse_block":
        wrong = [rel(dtype=torch.float32),
                 rel(dtype=torch.bfloat16, norm_dtype=torch.bfloat16)]
    else:
        wrong = [rel(norm_dtype=torch.float32)]
    assert min(wrong) > BF16_LAYER_REL, wrong


@pytest.mark.parametrize("cin,cout,chunks", [(256, 128, 2), (384, 64, 3),
                                              (256, 256, 1), (128, 64, 1)])
def test_stage_conv_chunks_equal_one_conv(cin, cout, chunks):
    """An RPN conv that narrows a map of more than CIN_CHUNK channels runs
    over CIN_CHUNK-channel input slices, summed: the same function."""
    calls = []
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=False)
    x = torch.randn(2, cin, 12, 10, generator=torch.Generator().manual_seed(0))
    real = torch.nn.functional.conv2d

    def counted(x, *a, **k):
        calls.append(x.shape[1])
        return real(x, *a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "conv2d", counted)
        with torch.no_grad():
            out = stage_conv(conv, x)
    assert len(calls) == chunks and sum(calls) == cin
    with torch.no_grad():
        torch.testing.assert_close(out, conv(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the middle and the whole predict step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense_from,dense_tail", [(2, True), (3, True),
                                                   (2, False)])
def test_middle_fp32_matches_jax(batch, dense_from, dense_tail):
    ref, var, feats, ex, plan = jax_middle("fp32", dense_from, dense_tail,
                                           batch)
    out = port_middle("fp32", dense_from, dense_tail, var, feats, ex, plan)
    assert out.shape == ref.shape == (2, 32, 32, 256)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_middle_bf16_close_to_jax_bf16(batch):
    ref, var, feats, ex, plan = jax_middle("bf16", 2, True, batch)
    out = port_middle("bf16", 2, True, var, feats, ex, plan)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < BF16_MIDDLE_REL, rel


@pytest.fixture(scope="module")
def predict(batch):
    """JAX's model.apply + predict and the port's forward and predict step
    on the same batch and weights, fp32. The class convs are scaled by
    CLS_GAIN and their biases set to CLS_BIAS, so that every task has
    candidates above the score threshold and no score lies near a cut
    (test_predict_scores_clear_of_the_cuts)."""
    jmodel, vg, asg, cids, test_cfg = jbuild_stack(
        cbgs_config(jax_side=True))
    test_cfg["nms"]["nms_pre_max_size"] = PRE_MAX
    plan, ex = jax_example(jmodel, vg, asg, cids, batch)
    var = random_variables(jmodel.init, ex["voxels"],
                           ex["num_points_per_voxel"], ex["coordinates"],
                           seed=2, plan=jax_plan(plan))
    for t in range(N_TASKS):
        cls = var["params"]["bbox_head"][f"task_{t}"]["conv_cls"]
        cls["kernel"] = cls["kernel"] * CLS_GAIN
        cls["bias"] = np.full_like(cls["bias"], CLS_BIAS)
    heads = jax.jit(lambda v, e, p: jmodel.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False, plan=p))(var, ex, jax_plan(plan))
    det = jax.jit(lambda e, h: jmodel.predict(e, h, test_cfg))(ex, heads)
    tmodel, tvg, tasg, tcids, ttest = build_stack(cbgs_config(),
                                                  device="cpu")
    ttest["nms"]["nms_pre_max_size"] = PRE_MAX
    tmodel.load_state_dict(from_jax(var["params"], var["batch_stats"]),
                           strict=True)
    tplan = host_plan_fn(tmodel, tvg, voxelize=True)(batch["points"],
                                                     batch["num_points"])
    with torch.no_grad():
        theads = tmodel(*(torch.from_numpy(tplan[k]) for k in
                          ("voxels", "num_points_per_voxel", "coordinates")),
                        plan=torch_plan(tplan))
    out = make_predict_step(tmodel, tvg, tasg, tcids, ttest)(
        dict(batch, **tplan))
    return dict(heads=jax.tree_util.tree_map(np.asarray, heads),
                theads=[{k: v.numpy() for k, v in h.items()}
                        for h in theads],
                det={k: np.asarray(v) for k, v in det.items()}, out=out,
                test_cfg=test_cfg, var=var, tmodel=tmodel)


def test_converter_covers_every_tensor(predict):
    var, tmodel = predict["var"], predict["tmodel"]
    sd = from_jax(var["params"], var["batch_stats"])
    assert sorted(sd) == sorted(tmodel.state_dict())
    bb = [k for k in sd if k.startswith("backbone.")]
    # 3 SparseConvBNs, 4 + 4 blocks of two convs, 2 DenseConvBNs
    assert len([k for k in bb if k.endswith(".norm.mean")]) == 21
    assert len([k for k in bb if k.endswith(".bias")
                and ".norm." not in k]) == 16
    w = sd["backbone.DenseBasicBlock_3.DenseConvBN_1.weight"]
    j = var["params"]["backbone"]["DenseBasicBlock_3"]["DenseConvBN_1"][
        "kernel"]                                      # (27, I, O)
    assert w.shape == (128, 128, 3, 3, 3)
    np.testing.assert_array_equal(w[5, 7, 1, 2, 0].numpy(),
                                  j[1 * 9 + 2 * 3 + 0, 7, 5])


def test_predict_heads_match_jax(predict):
    assert len(predict["heads"]) == len(predict["theads"]) == N_TASKS
    for h, th in zip(predict["heads"], predict["theads"]):
        assert sorted(h) == sorted(th) == ["box_preds", "cls_preds"]
        for k in h:
            assert th[k].shape == h[k].shape
            np.testing.assert_allclose(th[k], h[k], **TOL)


def _task_scores(head, t):
    """(B, A) top class scores of task ``t``, in float64."""
    num_class = len(nusc.nusc_tasks()[t]["class_names"])
    logits = head["cls_preds"].astype(np.float64).reshape(
        head["cls_preds"].shape[0], -1, num_class)
    return (1.0 / (1.0 + np.exp(-logits))).max(axis=-1)


def test_predict_scores_clear_of_the_cuts(predict):
    """Both sides select the same candidates: no task's score lies closer
    to the score threshold, or to the pre-NMS top-k cut, than ten times the
    largest difference between the port's and JAX's scores (measured
    8.2e-7 on the CPU), and every task has candidates."""
    test_cfg = predict["test_cfg"]
    k = test_cfg["nms"]["nms_pre_max_size"]
    thr = test_cfg["score_threshold"]
    pairs = [(_task_scores(h, t), _task_scores(th, t)) for t, (h, th) in
             enumerate(zip(predict["heads"], predict["theads"]))]
    margin = 10 * max(np.abs(s - ts).max() for s, ts in pairs)
    assert margin < 1e-5
    for t, (scores, _) in enumerate(pairs):
        assert np.abs(scores - thr).min() > margin, t
        n_valid = (scores >= thr).sum(axis=1)
        assert (n_valid > 10).all(), (t, n_valid)
        srt = -np.sort(-scores, axis=1)
        assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > margin)).all()


def test_predict_step_matches_jax(predict):
    det, out = predict["det"], predict["out"]
    d = N_TASKS * POST_MAX
    assert out["box3d_lidar"].shape == det["box3d_lidar"].shape == (2, d, 9)
    np.testing.assert_array_equal(out["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(out["label_preds"].numpy(),
                                  det["label_preds"])
    v = det["valid"]
    assert (v.sum(axis=1) > 0).all()
    assert len(np.unique(det["label_preds"][v])) > 1
    np.testing.assert_allclose(out["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)
