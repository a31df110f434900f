"""The model variants no shipped config names, the port against the JAX
package on the CPU: the VoxelNet VFE readers, PointModule, the BEV and
stride anchors with BevBoxCoder, the remaining losses and the streaming
metrics, and their registration (the Nobn and RCNN middles:
tests/test_torch_variant_middles.py).

Mirrors tests/test_model_variants.py (:47, :57),
tests/test_target.py::test_bev_anchor_generator_range and
tests/test_metrics_losses.py (all six); each module also takes the same
seeded inputs as its JAX counterpart, with the JAX weights carried over by
``utils/convert.py::from_jax``. Tolerances: integer outputs (anchors'
layout, metric counts) equal; elementwise modules and losses within 1e-5
relative; middles and convs within 1e-4; gradients within 1e-4 relative
L2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.core import anchors as janchors
from det3d_tpu.models import losses as jlosses
from det3d_tpu.models import metrics as jmetrics
from det3d_tpu.models import necks as jnecks
from det3d_tpu.models import readers as jreaders
from det3d_tpu_torch.core import anchors as tanchors
from det3d_tpu_torch.models import losses as tlosses
from det3d_tpu_torch.models import metrics as tmetrics
from det3d_tpu_torch.models import necks as tnecks
from det3d_tpu_torch.models import readers as treaders
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import randomize

torch.set_num_threads(2)

MID_TOL = 1e-4          # middles: rtol, and atol as a share of the max
ELT_REL = 1e-5          # elementwise modules and losses
GRAD_REL = 1e-4         # gradients, relative L2
GRID = (16, 16, 40)     # (nx, ny, nz), the JAX tests' grid


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close(got, ref, rtol, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def sparse_inputs(rng, v=64, grid=GRID, c=4, b=1):
    """Unique random voxels of the JAX tests' grid (the depth has nz + 1
    layers), b samples of v rows, some padded."""
    d, h, w = grid[2] + 1, grid[1], grid[0]
    co = np.full((b, v, 3), -1, np.int32)
    for i in range(b):
        n = v - 5 * i
        lin = rng.choice(d * h * w, n, replace=False)
        co[i, :n] = np.stack([lin // (h * w), (lin // w) % h, lin % w], -1)
    feats = rng.randn(b, v, c).astype(np.float32)
    feats[co[..., 0] < 0] = 0.0
    return feats, co


def load(module, params, stats=None):
    """from_jax of a module's flax variables, as a detector's backbone."""
    sd = from_jax({"backbone": params}, {"backbone": stats or {}})
    missing, unexpected = module.load_state_dict(
        {k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    assert not missing and not unexpected
    return module


def jax_vars(module, *args, seed=0, static=(), **kw):
    """The module's flax variables (init under jax.jit: op by op, JAX's
    first run of a middle takes ~25 s here), BN parameters, statistics
    and biases randomized (tests/test_torch_modules.py::randomize)."""
    variables = jax.jit(lambda *a: module.init(
        jax.random.PRNGKey(0), *a, *static, train=False, **kw))(*args)
    variables = dict(variables)
    variables.setdefault("batch_stats", {})
    return randomize(variables, seed)


def test_reader_variants_registered():
    """Every variant this port adds is in its registry under the JAX
    package's name (tests/test_model_variants.py:47)."""
    import det3d_tpu_torch.models.builder  # noqa: F401
    from det3d_tpu_torch.core.anchors import ANCHOR_GENERATORS, BOX_CODERS
    from det3d_tpu_torch.models.registry import (BACKBONES, HEADS, LOSSES,
                                                 NECKS, READERS)
    for name in ("VFEV3_ablation", "SimpleVoxel", "VoxelFeatureExtractor"):
        assert READERS.get(name) is not None
    for name in ("SpMiddleFHDNobn", "RCNNSpMiddleFHD"):
        assert BACKBONES.get(name) is not None
    assert NECKS.get("PointModule") is not None
    assert HEADS.get("RegHead") is not None
    for name in ("GHMCLoss", "GHMRLoss", "BalancedL1Loss", "IoULoss",
                 "BoundedIoULoss", "BootstrappedSigmoidClassificationLoss"):
        assert LOSSES.get(name) is not None
    for name in ("anchor_generator_stride", "bev_anchor_generator_range"):
        assert ANCHOR_GENERATORS.get(name) is not None
    assert BOX_CODERS.get("bev_box_coder") is not None


@pytest.mark.parametrize("backbone", [
    dict(type="SpMiddleFHD", num_input_features=128),
    dict(type="SpMiddleFHDNobn", num_input_features=128),
    dict(type="RCNNSpMiddleFHD", num_input_features=128)])
def test_build_stack_names_the_variants(backbone):
    """build_stack builds SECOND's config with the original VoxelNet
    reader and each middle, and its host plans serve them."""
    from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
    from tests.test_torch_second import second_config
    cfg = second_config()
    cfg["model"] = dict(cfg["model"], reader=dict(
        type="VoxelFeatureExtractor", num_input_features=4,
        num_filters=(32, 128)), backbone=dict(
            backbone, norm_cfg=cfg["model"]["backbone"].get("norm_cfg")))
    model, vg = build_stack(cfg, device="cpu")[:2]
    assert type(model.reader).__name__ == "VoxelFeatureExtractor"
    assert type(model.backbone).__name__ == backbone["type"]
    assert not vg.fuse_mean                     # per-point voxels
    assert host_plan_fn(model, vg) is not None


# ---------------------------------------------------------------------------
# readers (voxel_encoder.py) and PointModule
# ---------------------------------------------------------------------------

def voxels(rng, b=2, v=24, t=5, c=4):
    vox = rng.randn(b, v, t, c).astype(np.float32)
    n = rng.randint(0, t + 1, (b, v)).astype(np.int32)
    vox[np.arange(t)[None, None, :] >= n[..., None]] = 0.0
    return vox, n


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("with_distance", [False, True])
def test_voxel_feature_extractor_matches_jax(rng, train, with_distance):
    """The original VoxelNet reader (two VFELayers, the final linear + BN,
    the voxel max): masked BN over the real voxels' rows, in eval and in
    training, with and without the distance channel."""
    vox, n = voxels(rng)
    jm = jreaders.VoxelFeatureExtractor(num_input_features=4,
                                        with_distance=with_distance)
    v = jax_vars(jm, jnp.asarray(vox), jnp.asarray(n), seed=2)
    ref, upd = jax.jit(lambda v_, x, n_: jm.apply(
        v_, x, n_, train=train, mutable=["batch_stats"]))(
            v, jnp.asarray(vox), jnp.asarray(n))
    m = load(treaders.VoxelFeatureExtractor(
        num_input_features=4, with_distance=with_distance),
        v["params"], v["batch_stats"]).train(train)
    with torch.no_grad():
        out = m(torch.from_numpy(vox), torch.from_numpy(n))
    assert out.shape == (2, 24, 128) and out.dtype == torch.float32
    close(out.numpy(), np.asarray(ref), ELT_REL * 10, "VFE")
    if train:
        stats = from_jax({"backbone": {}}, {"backbone": upd["batch_stats"]})
        for name, buf in m.named_buffers():
            close(buf.numpy(), stats["backbone." + name].numpy(), ELT_REL,
                  name)


@pytest.mark.parametrize("name", ["VFEV3_ablation", "SimpleVoxel"])
def test_mean_readers_match_jax(rng, name):
    vox, n = voxels(rng)
    jm = getattr(jreaders, name)(num_input_features=4)
    ref = np.asarray(jm.apply({}, jnp.asarray(vox), jnp.asarray(n)))
    out = getattr(treaders, name)(num_input_features=4)(
        torch.from_numpy(vox), torch.from_numpy(n))
    assert out.shape == ref.shape
    close(out.numpy(), ref, ELT_REL, name)


@pytest.mark.parametrize("train", [False, True])
def test_point_module_matches_jax(rng, train):
    """PointModule (tests/test_model_variants.py:57): flatten, two Dense +
    BN + ReLU, the width-3 max filter; (6, 1, 1, 8)."""
    x = rng.randn(6, 2, 2, 8).astype(np.float32)
    jm = jnecks.PointModule(num_input_features=32, layers=(16, 8))
    v = jax_vars(jm, jnp.asarray(x), seed=4)
    ref, _ = jax.jit(lambda v_, x_: jm.apply(
        v_, x_, train=train, mutable=["batch_stats"]))(v, jnp.asarray(x))
    m = load(tnecks.PointModule(num_input_features=32, layers=(16, 8)),
             v["params"], v["batch_stats"]).train(train)
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert out.shape == (6, 1, 1, 8)
    close(out.numpy(), np.asarray(ref), ELT_REL, "PointModule")


# ---------------------------------------------------------------------------
# anchors and the BEV coder (tests/test_target.py:252)
# ---------------------------------------------------------------------------

def test_bev_anchor_generator_range():
    """BEV anchors: layout and centers (the JAX test's checks), equal to
    the JAX generator's, the velocity variant, and BevBoxCoder's encode
    and decode against JAX's, round trip included."""
    kw = dict(anchor_ranges=[0.0, -4.0, 8.0, 4.0], sizes=[1.6, 3.9],
              rotations=[0.0, np.pi / 2], class_name="Car",
              match_threshold=0.6, unmatch_threshold=0.45)
    gen = tanchors.ANCHOR_GENERATORS.get("bev_anchor_generator_range")(**kw)
    assert gen.ndim == 5 and gen.num_anchors_per_localization == 2
    h, w = 4, 8
    anchors = gen.generate([1, h, w])
    assert anchors.shape == (h, w, 1, 2, 5)
    stride = 8.0 / w
    np.testing.assert_allclose(anchors[0, 0, 0, 0],
                               [stride / 2, -4.0 + stride / 2, 1.6, 3.9, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(anchors[0, 1, 0, 0, 0], 3 * stride / 2,
                               atol=1e-6)
    np.testing.assert_allclose(anchors[1, 0, 0, 0, 1],
                               -4.0 + 8.0 / h + stride / 2, atol=1e-6)
    np.testing.assert_array_equal(
        anchors, janchors.BevAnchorGeneratorRange(**kw).generate([1, h, w]))
    gv = dict(kw, velocities=[0.1, -0.2], rotations=[0.0])
    av = tanchors.BevAnchorGeneratorRange(**gv).generate([1, h, w])
    assert av.shape == (h, w, 1, 1, 7)
    np.testing.assert_array_equal(
        av, janchors.BevAnchorGeneratorRange(**gv).generate([1, h, w]))

    rng = np.random.RandomState(0)
    a = anchors.reshape(-1, 5)
    boxes = np.stack([a[:, 0] + rng.uniform(-1, 1, len(a)),
                      a[:, 1] + rng.uniform(-1, 1, len(a)),
                      rng.uniform(-2, 0, len(a)),
                      rng.uniform(1, 2, len(a)), rng.uniform(3, 5, len(a)),
                      rng.uniform(1, 2, len(a)),
                      rng.uniform(-3, 3, len(a))], -1).astype(np.float32)
    for vec in (False, True):
        cfg = dict(type="bev_box_coder", encode_angle_vector=vec,
                   z_fixed=-1.5, h_fixed=1.8)
        coder = tanchors.build_box_coder(cfg)
        jcoder = janchors.build_box_coder(cfg)
        assert coder.code_size == jcoder.code_size == (6 if vec else 5)
        enc = coder.encode(torch.from_numpy(boxes), torch.from_numpy(a))
        jenc = np.asarray(jcoder.encode(jnp.asarray(boxes), jnp.asarray(a)))
        close(enc.numpy(), jenc, ELT_REL, "encode")
        dec = coder.decode(enc, torch.from_numpy(a)).numpy()
        close(dec, np.asarray(jcoder.decode(jnp.asarray(jenc),
                                            jnp.asarray(a))), ELT_REL,
              "decode")
        np.testing.assert_allclose(dec[:, [0, 1, 3, 4]],
                                   boxes[:, [0, 1, 3, 4]], atol=1e-4)
        assert np.all(dec[:, 2] == -1.5) and np.all(dec[:, 5] == 1.8)


def test_anchor_generator_stride_matches_jax():
    """With velocities, equal to JAX's generator; without, JAX's generator
    raises (it stacks the sizes with an empty (0, 2) velocity array), so
    the port is held to JAX's meshgrid assembly of the same centers."""
    kw = dict(sizes=[1.6, 3.9, 1.56], anchor_strides=[0.4, 0.4, 1.0],
              anchor_offsets=[0.2, -39.8, -1.78], rotations=[0, np.pi / 2],
              class_name="Car")
    make = tanchors.ANCHOR_GENERATORS.get("anchor_generator_stride")
    gen = make(**kw, velocities=[0.5, -0.5])
    ref = janchors.AnchorGeneratorStride(**kw, velocities=[0.5, -0.5])
    assert gen.ndim == ref.ndim == 9
    assert (gen.num_anchors_per_localization
            == ref.num_anchors_per_localization == 2)
    np.testing.assert_array_equal(gen.generate([2, 5, 7]),
                                  ref.generate([2, 5, 7]))
    with pytest.raises(ValueError):
        janchors.AnchorGeneratorStride(**kw).generate([2, 5, 7])
    got = make(**kw).generate([2, 5, 7])
    f32 = np.float32
    want = janchors._mesh_anchors(
        np.arange(7, dtype=f32) * f32(0.4) + f32(0.2),
        np.arange(5, dtype=f32) * f32(0.4) + f32(-39.8),
        np.arange(2, dtype=f32) * f32(1.0) + f32(-1.78),
        kw["sizes"], kw["rotations"], None, f32)
    assert make(**kw).ndim == 7 and got.shape == (2, 5, 7, 1, 2, 7)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# losses (tests/test_metrics_losses.py:71-150)
# ---------------------------------------------------------------------------

def _boxes(rng, n):
    x1 = rng.uniform(0, 20, (n, 2))
    return np.concatenate([x1, x1 + rng.uniform(1, 10, (n, 2))],
                          -1).astype(np.float32)


LOSS_CASES = {
    "GHMCLoss": dict(bins=10),
    "GHMRLoss": dict(mu=0.02, bins=10),
    "BalancedL1Loss": dict(alpha=0.5, gamma=1.5, beta=1.0),
    "IoULoss": dict(),
    "BoundedIoULoss": dict(beta=0.2),
    "BootstrappedSigmoidClassificationLoss": dict(alpha=0.5),
    "BootstrappedSigmoidClassificationLoss-hard": dict(
        alpha=0.5, bootstrap_type="hard"),
}


def loss_inputs(name, rng):
    if name.startswith(("IoU", "Bounded")):
        pred = _boxes(rng, 16)
        target = pred + rng.uniform(-2, 2, pred.shape).astype(np.float32)
        return pred, target, rng.uniform(0, 1, (16,)).astype(np.float32)
    if name.startswith(("GHMC", "Boot")):
        pred = rng.normal(0, 2, (2, 16, 3)).astype(np.float32)
        target = (rng.uniform(0, 1, (2, 16, 3)) > 0.7).astype(np.float32)
    else:
        pred = rng.normal(0, 1, (2, 16, 7)).astype(np.float32)
        target = rng.normal(0, 1, (2, 16, 7)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    w[0, :3] = -1.0 if name.startswith("GHMC") else 0.0
    return pred, target, w


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(rng, name):
    """Each loss and its gradient against JAX's on seeded inputs."""
    kind = name.split("-")[0]
    pred, target, w = loss_inputs(name, rng)
    jl = getattr(jlosses, kind)(**LOSS_CASES[name])
    tl = tlosses.LOSSES.get(kind)(**LOSS_CASES[name])
    def jfn(p, t, w_):
        return jl(p, t, w_), jax.value_and_grad(
            lambda q: jnp.sum(jl(q, t, w_) ** 2))(p)

    jout, (ref, jgrad) = jax.jit(jfn)(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(w))
    p = torch.from_numpy(pred).requires_grad_(True)
    out = tl(p, torch.from_numpy(target), torch.from_numpy(w))
    close(out.detach().numpy(), np.asarray(jout), ELT_REL, name)
    (out ** 2).sum().backward()
    assert rel_l2(p.grad.numpy(), jgrad) <= ELT_REL * 10, name
    close(float((out.detach() ** 2).sum()), float(ref), ELT_REL, name)


def test_ghm_histogram_on_the_device_of_its_inputs(rng):
    """GHM's histogram is explicit per-call state on the inputs' device:
    its counts are those of the valid elements' gradient-norm bins."""
    pred, target, w = loss_inputs("GHMCLoss", rng)
    weights, hist = tlosses.GHMCLoss(bins=10).histogram(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(w))
    g = np.abs(1 / (1 + np.exp(-pred)) - target)
    valid = np.broadcast_to((w >= 0)[..., None], pred.shape)
    want = np.bincount(np.clip((g * 10).astype(int), 0, 9)[valid],
                       minlength=10)
    np.testing.assert_array_equal(hist.numpy(), want)
    assert hist.device == weights.device


def test_balanced_l1_matches_formula():
    loss = tlosses.BalancedL1Loss(alpha=0.5, gamma=1.5, beta=1.0)
    out = loss(torch.tensor([[0.3, 2.5]]), torch.tensor([[0.0, 0.0]]))
    b = np.e ** (1.5 / 0.5) - 1
    d = 0.3
    small = 0.5 / b * (b * d + 1) * np.log(b * d + 1) - 0.5 * d
    large = 1.5 * 2.5 + 1.5 / b - 0.5
    np.testing.assert_allclose(out[0].numpy(), [small, large], rtol=1e-5)


def test_iou_and_bounded_iou_loss():
    pred = torch.tensor([[0.0, 0.0, 9.0, 9.0]])
    np.testing.assert_allclose(tlosses.IoULoss()(pred, pred).numpy(), 0.0,
                               atol=1e-5)
    np.testing.assert_allclose(tlosses.BoundedIoULoss()(pred, pred).numpy(),
                               0.0, atol=1e-6)
    shifted = torch.tensor([[1.0, 0.0, 10.0, 9.0]])
    assert float(tlosses.IoULoss()(pred, shifted).sum()) > 0.05
    assert float(tlosses.BoundedIoULoss()(pred, shifted).sum()) > 0.01


def test_bootstrapped_sigmoid_interpolates():
    logits = torch.tensor([[[2.0, -1.0]]])
    target = torch.tensor([[[1.0, 0.0]]])
    w = torch.ones((1, 1))
    full = tlosses.BootstrappedSigmoidClassificationLoss(alpha=1.0)(
        logits, target, w)
    plain = tlosses._sigmoid_cross_entropy_with_logits(target, logits)
    np.testing.assert_allclose(full.numpy(), plain.numpy(), rtol=1e-6)
    soft = tlosses.BootstrappedSigmoidClassificationLoss(alpha=0.5)(
        logits, target, w)
    hard = tlosses.BootstrappedSigmoidClassificationLoss(
        alpha=0.5, bootstrap_type="hard")(logits, target, w)
    assert not np.allclose(soft.numpy(), hard.numpy())


# ---------------------------------------------------------------------------
# streaming metrics (tests/test_metrics_losses.py:7-68)
# ---------------------------------------------------------------------------

def test_streaming_accuracy_precision_recall():
    acc = tmetrics.Accuracy(threshold=0.5)
    st = acc.init("cpu")
    st, v = acc.update(st, torch.tensor([[1, 0, 1]]),
                       torch.tensor([[[3.0], [-2.0], [0.2]]]))
    assert abs(float(v) - 1.0) < 1e-6
    st, v = acc.update(st, torch.tensor([[1, 0, 0]]),
                       torch.tensor([[[-3.0], [-3.0], [-3.0]]]))
    assert abs(float(v) - 5.0 / 6) < 1e-6
    prec, rec = tmetrics.Precision(), tmetrics.Recall()
    logits = torch.tensor([[[2.0], [2.0], [-2.0], [-2.0]]])
    labels = torch.tensor([[1, 0, 1, 0]])
    _, pv = prec.update(prec.init(), labels, logits)
    _, rv = rec.update(rec.init(), labels, logits)
    assert abs(float(pv) - 0.5) < 1e-6 and abs(float(rv) - 0.5) < 1e-6
    sc = tmetrics.Scalar()
    ss = sc.init()
    for x in (2.0, 0.0, 4.0):
        ss, v = sc.update(ss, torch.tensor(x))
    assert abs(float(v) - 3.0) < 1e-6


def test_precision_recall_multi_threshold():
    m = tmetrics.PrecisionRecall(thresholds=(0.3, 0.7))
    _, (prec, rec) = m.update(m.init(), torch.tensor([[1, 0, 1]]),
                              torch.tensor([[[2.0], [-1.0], [0.5]]]))
    np.testing.assert_allclose(prec.numpy(), [1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(rec.numpy(), [1.0, 0.5], atol=1e-6)


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall",
                                  "PrecisionRecall", "Scalar"])
def test_metric_states_equal_jax(rng, name):
    """Three streamed batches of seeded logits and labels (ignored rows
    included): the states' counts equal JAX's, the values within 1e-6."""
    kw = {"PrecisionRecall": dict(thresholds=(0.2, 0.5, 0.8))}.get(name, {})
    jm, tm = getattr(jmetrics, name)(**kw), getattr(tmetrics, name)(**kw)
    js, ts = jm.init(), tm.init("cpu")
    for _ in range(3):
        if name == "Scalar":
            x = np.float32(rng.choice([0.0, rng.randn()]))
            js, jv = jm.update(js, jnp.asarray(x))
            ts, tv = tm.update(ts, torch.tensor(x))
        else:
            c = 2 if name in ("Precision", "Recall") and rng.rand() < 0.5 \
                else 1
            logits = rng.randn(2, 10, c).astype(np.float32)
            labels = rng.randint(-1, 2, (2, 10)).astype(np.int64)
            js, jv = jm.update(js, jnp.asarray(labels), jnp.asarray(logits))
            ts, tv = tm.update(ts, torch.from_numpy(labels),
                               torch.from_numpy(logits))
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        jv = jv if isinstance(jv, tuple) else (jv,)
        tv = tv if isinstance(tv, tuple) else (tv,)
        for a, b in zip(tv, jv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
