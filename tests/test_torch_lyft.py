"""CBGS Lyft serving from host plans: the port against the JAX package, on
the CPU.

The shipped configs/lyft_cbgs_voxelnet.py, cut to a +-12.8 m range with
``max_voxel_num`` 1024 (the middle's, the RPN's and the 5-task head's
widths stay full: 0.1 x 0.1 x 0.15 m voxels, 5 point features,
SpMiddleResNetFHD with ``dense_from=2`` and no ``serve_precision``, so the
middle serves in fp32; the 9-dim velocity coder with vector angles, the
fused cross-task NMS at thr 0.2), on structured scans:

- the shipped config loads through the port's ``Config`` without
  importing the JAX package (in a subprocess);
- the anchors of the 7 generators (velocities written inline) and the
  class ids of the 5 tasks equal the JAX package's at the shipped
  (1, 252, 252) feature map;
- the host plans and voxels equal the JAX package's, array for array, on
  the cut range and once at full scale: one scan of 300000 points over
  +-100.8 m, more occupied voxels than the 80000-voxel cap;
- the fp32 middle (21 window convs on fp32 operands, 10 of them the dense
  tail's) agrees with JAX's within rtol = atol = 1e-4;
- an fp32 RPN conv over a batch of maps as large as Lyft's runs one map at
  a time (models/necks.py::stage_conv), the same function as one conv;
- each kind of dense-tail layer, run on the active rows over the tail's
  own rulebooks (models/backbones.py::DenseConvBN.rows), equals its dense
  forward;
- the whole predict step agrees with JAX's ``model.apply`` + ``predict``:
  the same valid masks and labels, boxes and scores within 1e-4, shape
  (B, 5 x 83, 9), every tensor carried over by ``from_jax``.
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

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.models import backbones, necks
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.ops import sparse_host as sph
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils.config import Config
from det3d_tpu_torch.utils.convert import from_jax
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_cbgs import jax_example, random_variables
from tests.test_torch_second import jax_plan, torch_plan

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LYFT_CFG = os.path.join(REPO, "configs", "lyft_cbgs_voxelnet.py")
EXTENT = 12.8
PC = (-EXTENT, -EXTENT, -4.0, EXTENT, EXTENT, 2.0)
FULL_PC = (-100.8, -100.8, -4.0, 100.8, 100.8, 2.0)
TOL = dict(rtol=1e-4, atol=1e-4)
N_TASKS, POST_MAX = 5, 83
LAUNCHES = 21               # window convs of a forward (11 sparse, 10 of
                            # the tail), as on the card
CLS_GAIN, CAND_SHARE = 5.0, 0.2        # the class convs of test_predict_*
# the predict tests' nms_pre_max_size (shipped: 1000, which chip_smoke runs
# on the card): the plain NMS twin computes the IoU of every pair on the
# CPU, the fused 10 samples at K=1000 take seconds here
PRE_MAX = 300


def lyft_config():
    """configs/lyft_cbgs_voxelnet.py over the +-12.8 m range, 1024 voxels,
    every anchor generator over the same range."""
    cfg = Config.fromfile(LYFT_CFG)
    c = {k: copy.deepcopy(cfg[k]) for k in
         ("tasks", "model", "assigner", "test_cfg", "voxel_generator",
          "train_cfg")}
    c["voxel_generator"].update(range=list(PC), max_voxel_num=1024)
    for g in c["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [-EXTENT, -EXTENT, z, EXTENT, EXTENT, z]
    return c


def shipped_config():
    cfg = Config.fromfile(LYFT_CFG)
    return {k: copy.deepcopy(cfg[k]) for k in
            ("tasks", "model", "assigner", "test_cfg", "voxel_generator")}


def lyft_batch(b, points, pc, seed):
    """Structured scans with Lyft's 5 point features (the fifth, the sweep
    time, zero)."""
    d = structured_batch(b, points, pc, seed=seed)
    p = d["points"]
    d["points"] = np.concatenate([p, np.zeros_like(p[..., :1])], -1)
    return d


@pytest.fixture(scope="module")
def batch():
    return lyft_batch(2, 3000, PC, seed=3)


def assert_plans_equal(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# config, anchors, host data
# ---------------------------------------------------------------------------

def test_shipped_config_loads_without_the_jax_package():
    """The config imports only itertools and os; no det3d_tpu module is
    imported (a fresh process: this one has imported the JAX package)."""
    code = (
        "import sys\n"
        "from det3d_tpu_torch.utils.config import Config\n"
        f"cfg = Config.fromfile({LYFT_CFG!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('det3d_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
        "bb = cfg['model']['backbone']\n"
        "assert bb['type'] == 'SpMiddleResNetFHD' and bb['dense_from'] == 2\n"
        "assert 'serve_precision' not in bb\n"
        "assert len(cfg['tasks']) == 5\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_anchors_and_class_ids_equal_jax():
    """The shipped config: 7 generators with inline velocities over 5
    tasks, 889,056 anchors a scan at the (1, 252, 252) feature map."""
    c = shipped_config()
    model, vg, asg, cids, _ = build_stack(c, device="cpu")
    _, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(c))
    assert vg.grid_size == jvg.grid_size == (2016, 2016, 40)
    assert cids == jcids == [[1], [2], [3, 4], [5], [6, 7]]
    assert len(asg) == len(jasg) == N_TASKS
    for a, ja in zip(asg, jasg):
        ours, ref = a.anchors_flat, np.asarray(ja.anchors_flat)
        assert ours.shape == (252 * 252 * 2 * len(a.anchor_generators), 9)
        np.testing.assert_array_equal(ours, ref)
    assert sum(a.anchors_flat.shape[0] for a in asg) == 889056
    # no serve_precision: the middle serves in fp32
    assert model.backbone.dtype == torch.float32


def test_host_plan_fn_equals_jax(batch):
    model, vg = build_stack(lyft_config(), device="cpu")[:2]
    jmodel, jvg = jbuild_stack(lyft_config())[:2]
    assert vg.effective_order == jvg.effective_order == "hashed"
    ours = host_plan_fn(model, vg, voxelize=True)(batch["points"],
                                                  batch["num_points"])
    ref = jhost_plan_fn(jmodel, jvg, train=False, voxelize=True)(
        batch["points"], batch["num_points"])
    assert_plans_equal(ours, ref)
    assert sorted(k for k in ours if k.startswith("plan_down")) == [
        "plan_down1", "plan_down2"]
    assert ours["voxels"].shape == (2, 1024, 5)
    assert (ours["num_voxels"] > 500).all()


def test_host_plan_full_scale_overflow_equals_jax():
    """One scan as chip_smoke feeds the card: 300000 points over +-100.8 m
    occupy more voxels than the 80000-voxel cap, so the hashed order
    decides which stay; the (41, 2016, 2016) grid's linear ids reach
    1.67e8. Plans and voxels equal the JAX package's."""
    c = shipped_config()
    model, vg = build_stack(c, device="cpu")[:2]
    jmodel, jvg = jbuild_stack(copy.deepcopy(c))[:2]
    scan = lyft_batch(1, 300000, FULL_PC, seed=3)
    ours = host_plan_fn(model, vg, voxelize=True)(scan["points"],
                                                  scan["num_points"])
    ref = jhost_plan_fn(jmodel, jvg, train=False, voxelize=True)(
        scan["points"], scan["num_points"])
    assert_plans_equal(ours, ref)
    lin = sph.point_lin(scan["points"][0], scan["num_points"][0],
                        vg.voxel_size, vg.point_cloud_range, vg.grid_size)
    occupied = len(np.unique(lin[lin != sph.SENTINEL]))
    assert occupied > 80000
    assert int(ours["num_voxels"][0]) == 80000
    assert ours["voxels"].shape == (1, 80000, 5)


# ---------------------------------------------------------------------------
# the fp32 middle and the whole predict step
# ---------------------------------------------------------------------------

def fp32_middle(config, batch, monkeypatch):
    """The JAX middle and the port's on ``batch``, ``config`` as shipped
    (fp32), random weights and statistics: (the port's output, JAX's, the
    operand dtypes of each window conv the port called, in order)."""
    jmodel, vg, asg, cids, _ = jbuild_stack(config)
    plan, ex = jax_example(jmodel, vg, asg, cids, batch)
    var = random_variables(
        functools.partial(jmodel.backbone.init, input_shape=jmodel.grid_size),
        ex["voxels"], ex["coordinates"], seed=1, plan=jax_plan(plan))
    feats = jmodel.reader.apply({}, ex["voxels"], ex["num_points_per_voxel"])
    ref = np.asarray(jax.jit(lambda v, x, c, p: jmodel.backbone.apply(
        v, x, c, jmodel.grid_size, train=False, plan=p))(
            var, feats, ex["coordinates"], jax_plan(plan)))

    model = build_stack(config, device="cpu")[0]
    sd = from_jax({"backbone": var["params"]},
                  {"backbone": var["batch_stats"]})
    model.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    calls, real = [], backbones.window_conv

    def spy(x, packed, w, center_shift, *inverse):
        calls.append((x.dtype, w.dtype))
        return real(x, packed, w, center_shift, *inverse)
    monkeypatch.setattr(backbones, "window_conv", spy)
    with torch.no_grad():
        out = model.backbone(torch.from_numpy(np.array(feats)),
                             torch.from_numpy(np.array(ex["coordinates"])),
                             model.grid_size, plan=torch_plan(plan))
    return out, ref, calls


def test_middle_fp32_matches_jax(batch, monkeypatch):
    """The shipped middle (fp32, dense_from=2): 21 window convs, each on
    fp32 operands, and the output within 1e-4 of JAX's."""
    out, ref, calls = fp32_middle(lyft_config(), batch, monkeypatch)
    assert calls == [(torch.float32, torch.float32)] * LAUNCHES
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 32, 32, 256)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def logit_cut(logits, share):
    """A cut with about ``share`` of ``logits`` above it, at the middle of
    the widest gap between two neighbouring logits near that share, so that
    no logit lies near it (a random trunk gives every empty BEV cell one
    logit: the cut never splits such a plateau)."""
    srt = np.sort(logits.ravel())
    n = srt.size
    lo, hi = int(n * (1 - 1.5 * share)), int(n * (1 - 0.5 * share))
    i = lo + int(np.argmax(np.diff(srt[lo:hi])))
    return 0.5 * (srt[i] + srt[i + 1])


@pytest.mark.parametrize("cin,cout,b,stride,dtype,calls", [
    (128, 128, 2, 1, torch.float32, 2),     # one call per map
    (256, 128, 2, 1, torch.float32, 4),     # per map, then 2 chunks each
    (128, 256, 2, 2, torch.float32, 1),     # strided: one call
    (128, 128, 1, 1, torch.float32, 1),     # one map
    (128, 128, 2, 1, torch.bfloat16, 1),    # bf16: one call
])
def test_stage_conv_per_map_equals_one_conv(cin, cout, b, stride, dtype,
                                            calls, monkeypatch):
    """An fp32 stride-1 RPN conv over more than one map of SPLIT_PIXELS or
    more (Lyft's 252 x 252; here SPLIT_PIXELS is cut to the test's 12 x 10
    maps) runs one map at a time: the same function as one conv, within
    1e-4."""
    F = torch.nn.functional
    monkeypatch.setattr(necks, "SPLIT_PIXELS", 12 * 10)
    conv = torch.nn.Conv2d(cin, cout, 3, stride=stride, padding=1,
                           bias=False)
    x = torch.randn(b, cin, 12, 10,
                    generator=torch.Generator().manual_seed(0)).to(dtype)
    seen, real = [], F.conv2d

    def counted(x, *a, **k):
        seen.append(tuple(x.shape))
        return real(x, *a, **k)
    monkeypatch.setattr(F, "conv2d", counted)
    with torch.no_grad():
        out = necks.stage_conv(conv, x)
    monkeypatch.setattr(F, "conv2d", real)
    assert len(seen) == calls
    if calls > 1:
        assert all(s[0] == 1 for s in seen)
    with torch.no_grad():
        ref = real(x, conv.weight.to(dtype), stride=stride, padding=1)
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cin,cout,kernel,stride,padding,dtype", [
    (128, 128, 3, 1, 1, torch.float32),               # Lyft's res3 subm
    (64, 128, 3, 2, (0, 1, 1), torch.float32),        # its stage-3 conv
    (128, 128, (3, 1, 1), (2, 1, 1), 0, torch.float32),   # the z conv
    (128, 128, 3, 1, 1, torch.bfloat16),              # bf16 (CBGS)
])
def test_dense_tail_layer_rows_equal_dense_forward(cin, cout, kernel, stride,
                                                   padding, dtype):
    """A dense-tail layer on the active rows (DenseConvBN.rows over the
    rulebook models/backbones.py::_RowsTail builds, every strided output
    kept) equals its dense forward at the active sites of its output and
    matches its zeros elsewhere: fp32 within 1e-4, bf16 within 1e-2."""
    g = torch.Generator().manual_seed(0)
    layer = backbones.DenseConvBN(
        cin, cout, kernel=kernel, stride=stride, padding=padding,
        norm_cfg={"type": "BN"}, use_bias=True,
        precision="bf16" if dtype == torch.bfloat16 else "fp32").eval()
    with torch.no_grad():
        layer.bias.copy_(0.1 * torch.randn(cout, generator=g))
        layer.norm.mean.copy_(0.1 * torch.randn(cout, generator=g))
    shape = (5, 12, 10)
    occ = torch.rand((2,) + shape, generator=g) < 0.3
    x = (torch.relu(torch.randn((2,) + shape + (cin,), generator=g))
         * occ[..., None]).to(dtype)
    b, z, y, xx = torch.nonzero(occ, as_tuple=True)
    co = torch.full((2, 200, 3), -1, dtype=torch.int32)
    rows = torch.zeros((2, 200, cin), dtype=dtype)
    for i in range(2):
        n = int((b == i).sum())
        co[i, :n] = torch.stack([z, y, xx], -1)[b == i].int()
        rows[i, :n] = x[i][occ[i]]
    order = sp.yxz_order(co, shape)
    co = torch.gather(co, 1, order[..., None].expand(-1, -1, 3))
    rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, cin))
    with torch.no_grad():
        tail = backbones._RowsTail(rows, co, shape, None, False)
        if layer.stride == (1, 1, 1):
            tail.blocks([layer])
            occ_out = occ
        else:
            tail.down(layer, last=True)
            occ_out = torch.nn.functional.max_pool3d(
                occ[:, None].float(), layer.kernel, layer.stride,
                layer.padding)[:, 0] > 0
        ref = layer(x, occ_out)
    got = sp.to_dense(tail.x, tail.co, tail.shape)
    assert got.dtype == ref.dtype == dtype
    assert int((tail.co[..., 0] >= 0).sum()) == int(occ_out.sum())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def predict_pair(config, batch, cand_share, pre_max=None):
    """JAX's model.apply + predict and the port's forward and predict step
    on the same batch and weights, ``config`` as shipped but for
    ``pre_max`` (nms_pre_max_size). The class convs are scaled by CLS_GAIN
    and each task's class bias is set so that about ``cand_share`` of its
    anchors score above the threshold (the random trunk shifts each task's
    logits by its own amount), so that every task has candidates and no
    score lies near a cut (assert_scores_clear)."""
    jmodel, vg, asg, cids, test_cfg = jbuild_stack(copy.deepcopy(config))
    if pre_max is not None:
        test_cfg["nms"]["nms_pre_max_size"] = pre_max
    plan, ex = jax_example(jmodel, vg, asg, cids, batch)
    var = random_variables(jmodel.init, ex["voxels"],
                           ex["num_points_per_voxel"], ex["coordinates"],
                           seed=2, plan=jax_plan(plan))
    apply = jax.jit(lambda v, e, p: jmodel.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False, plan=p))
    convs = [var["params"]["bbox_head"][f"task_{t}"]["conv_cls"]
             for t in range(len(config["tasks"]))]
    for cls in convs:
        cls["kernel"] = cls["kernel"] * CLS_GAIN
    thr = float(test_cfg["score_threshold"])
    for cls, head in zip(convs, apply(var, ex, jax_plan(plan))):
        cls["bias"] = np.full_like(cls["bias"], np.log(thr / (1 - thr))
                                   - logit_cut(np.asarray(head["cls_preds"])
                                               - cls["bias"], cand_share))
    heads = apply(var, ex, jax_plan(plan))
    det = jax.jit(lambda e, h: jmodel.predict(e, h, test_cfg))(ex, heads)
    tmodel, tvg, tasg, tcids, ttest = build_stack(copy.deepcopy(config),
                                                  device="cpu")
    if pre_max is not None:
        ttest["nms"]["nms_pre_max_size"] = pre_max
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
                test_cfg=test_cfg, var=var, tmodel=tmodel,
                tasks=config["tasks"])


def assert_scores_clear(predict):
    """Both sides select the same candidates: no task's score lies closer
    to the score threshold, or to the pre-NMS top-k cut, than ten times the
    largest difference between the port's and JAX's scores (measured at
    most 1.02e-6 on the CPU), and every task has candidates."""
    test_cfg = predict["test_cfg"]
    k = test_cfg["nms"]["nms_pre_max_size"]
    thr = test_cfg["score_threshold"]

    def scores(head, task):
        """(B, A) top class scores of a task's head, in float64."""
        logits = head["cls_preds"].astype(np.float64).reshape(
            head["cls_preds"].shape[0], -1, len(task["class_names"]))
        return (1.0 / (1.0 + np.exp(-logits))).max(axis=-1)
    pairs = [(scores(h, task), scores(th, task)) for h, th, task in
             zip(predict["heads"], predict["theads"], predict["tasks"])]
    diff = max(np.abs(s - ts).max() for s, ts in pairs)
    assert diff < 1e-5
    margin = 10 * diff
    for t, (s, _) in enumerate(pairs):
        assert np.abs(s - thr).min() > margin, t
        n_valid = (s >= thr).sum(axis=1)
        assert (n_valid > 10).all(), (t, n_valid)
        srt = -np.sort(-s, axis=1)
        assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > margin)).all()


@pytest.fixture(scope="module")
def predict(batch):
    return predict_pair(lyft_config(), batch, CAND_SHARE, PRE_MAX)


def test_converter_covers_every_tensor(predict):
    var, tmodel = predict["var"], predict["tmodel"]
    sd = from_jax(var["params"], var["batch_stats"])
    assert sorted(sd) == sorted(tmodel.state_dict())
    bb = [k for k in sd if k.startswith("backbone.")]
    # 3 SparseConvBNs, 4 + 4 blocks of two convs, 2 DenseConvBNs
    assert len([k for k in bb if k.endswith(".norm.mean")]) == 21
    # 5 tasks, a box and a class conv each, no direction classifier
    head = {k.split(".")[2] for k in sd if k.startswith("bbox_head.")}
    assert head == {"conv_box", "conv_cls"}
    w = sd["backbone.DenseConvBN_0.weight"]
    j = var["params"]["backbone"]["DenseConvBN_0"]["kernel"]    # (27, I, O)
    assert w.shape == (128, 64, 3, 3, 3)
    np.testing.assert_array_equal(w[5, 7, 2, 0, 1].numpy(),
                                  j[2 * 9 + 0 * 3 + 1, 7, 5])


def test_predict_heads_match_jax(predict):
    assert len(predict["heads"]) == len(predict["theads"]) == N_TASKS
    for h, th in zip(predict["heads"], predict["theads"]):
        assert sorted(h) == sorted(th) == ["box_preds", "cls_preds"]
        for k in h:
            assert th[k].shape == h[k].shape
            np.testing.assert_allclose(th[k], h[k], **TOL)


def test_predict_scores_clear_of_the_cuts(predict):
    assert_scores_clear(predict)


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
