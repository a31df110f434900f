"""Targets and losses: the port against the JAX package, on the CPU.

- ``second_box_encode`` for every coder option (7 / 9 dims, vector angle,
  ``smooth_dim``, ``norm_velo``) within 1e-6 of JAX's, and inverted by
  the port's ``second_box_decode``;
- the standup IoU (with its ``eps``), the three similarity functions and
  ``rotated_iou_matrix`` against JAX's;
- ``create_target`` with no gt, padded gt, force-match ties, gt kept 1e-4
  clear of both thresholds and an anchor mask: labels and reg weights
  array-equal to JAX's (JAX op by op, outside ``jax.jit``: the force
  match tests ``sim == max`` for exact float equality), reg targets within
  1e-5; the positive-fraction subsampling by its invariants (its draws
  come from a torch.Generator, JAX's from jax.random);
- ``TargetAssigner.assign`` in the layout of
  configs/smoke_kitti_pointpillars.py and a two-class task, and the
  anchor-area mask, equal to JAX's;
- each loss, the four loss norms, ``get_direction_target`` and
  ``MultiGroupHead.loss`` (every key within 1e-5) against JAX's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.core import box_ops as jbox
from det3d_tpu.core import geometry as jgeo
from det3d_tpu.core import target as jtarget
from det3d_tpu.models import heads as jheads
from det3d_tpu.models import losses as jlosses
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.core import box_ops, geometry, target
from det3d_tpu_torch.core.anchors import AnchorGeneratorRange, GroundBox3dCoder
from det3d_tpu_torch.models import heads, losses
from det3d_tpu_torch.parallel.train import build_example
from tests.test_torch_pointpillars import load

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ROT_TOL = dict(rtol=1e-5, atol=1e-5)    # rotated IoU: measured 3.3e-6


def t(x):
    return torch.as_tensor(np.array(x))


def boxes(rng, n, ndim=7):
    b = np.zeros((n, ndim), np.float32)
    b[:, 0] = rng.uniform(0, 20, n)
    b[:, 1] = rng.uniform(-10, 10, n)
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    if ndim == 9:
        b[:, 6:8] = rng.normal(0, 2, (n, 2))
    b[:, -1] = rng.uniform(-np.pi, np.pi, n)
    return b


# ---------------------------------------------------------------------------
# box encoding
# ---------------------------------------------------------------------------

CODERS = [(7, False, False, False), (7, True, False, False),
          (7, False, True, False), (9, False, False, False),
          (9, True, False, True), (9, False, True, True)]


@pytest.mark.parametrize("ndim,vec,smooth,norm_velo", CODERS)
def test_encode_equals_jax_and_inverts_decode(ndim, vec, smooth, norm_velo):
    rng = np.random.RandomState(ndim + 2 * vec + 4 * smooth)
    gt, anchors = boxes(rng, 300, ndim), boxes(rng, 300, ndim)
    kw = dict(encode_angle_to_vector=vec, smooth_dim=smooth,
              norm_velo=norm_velo)
    enc = box_ops.second_box_encode(t(gt), t(anchors), **kw)
    ref = jbox.second_box_encode(jnp.asarray(gt), jnp.asarray(anchors), **kw)
    torch.testing.assert_close(enc, t(ref), rtol=1e-6, atol=1e-6)
    dec = box_ops.second_box_decode(enc, t(anchors), **kw)
    want = t(gt).clone()
    if vec:     # the angle comes back through atan2, in (-pi, pi]
        want[:, -1] = torch.atan2(torch.sin(want[:, -1]),
                                  torch.cos(want[:, -1]))
    torch.testing.assert_close(dec, want, rtol=1e-4, atol=1e-4)
    coder = GroundBox3dCoder(linear_dim=smooth, vec_encode=vec, n_dim=ndim,
                             norm_velo=norm_velo)
    torch.testing.assert_close(coder.encode(t(gt), t(anchors)), enc)


# ---------------------------------------------------------------------------
# similarity
# ---------------------------------------------------------------------------

def bev(rng, n):
    return boxes(rng, n)[:, [0, 1, 3, 4, 6]]


@pytest.mark.parametrize("eps", [0.0, 1.0])
def test_iou_matrix_equals_jax(eps):
    rng = np.random.RandomState(1)
    a = np.asarray(jbox.rbbox2d_to_near_bbox(bev(rng, 60)))
    g = np.asarray(jbox.rbbox2d_to_near_bbox(bev(rng, 20)))
    ref = jbox.iou_matrix(jnp.asarray(a), jnp.asarray(g), eps=eps)
    out = box_ops.iou_matrix(t(a), t(g), eps=eps)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", sorted(target.SIMILARITY_FNS))
def test_similarity_equals_jax(name):
    """Each similarity on anchors (A, 5) and a batch of gt (B, G, 5)
    against JAX's per sample: nearest IoU array-equal, the others within
    ROT_TOL (the rotated corners come from sin and cos, which XLA and
    torch round differently in the last bit)."""
    rng = np.random.RandomState(2)
    anchors = bev(rng, 200)
    gt = np.stack([bev(rng, 6), bev(rng, 6)])
    gt[:, :2, :2] = anchors[:2, :2]          # some overlap
    out = target.SIMILARITY_FNS[name](t(anchors), t(gt)).numpy()
    for i in range(2):
        ref = np.asarray(jtarget.SIMILARITY_FNS[name](
            jnp.asarray(anchors), jnp.asarray(gt[i])))
        if name == "nearest_iou_similarity":
            np.testing.assert_array_equal(out[i], ref)
        else:
            np.testing.assert_allclose(out[i], ref, **ROT_TOL)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_matrix_equals_jax(criterion):
    rng = np.random.RandomState(3)
    a, g = bev(rng, 40), bev(rng, 30)
    g[:10] = a[:10] + [0.3, -0.2, 0.0, 0.0, 0.1]
    out = geometry.rotated_iou_matrix(t(a), t(g), criterion)
    ref = jgeo.rotated_iou_matrix(jnp.asarray(a), jnp.asarray(g), criterion)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ROT_TOL)
    assert float(out.max()) > 0.3


# ---------------------------------------------------------------------------
# create_target
# ---------------------------------------------------------------------------

MT, UT = 0.6, 0.45


def grid_anchors():
    gen = AnchorGeneratorRange(
        anchor_ranges=[0, -10, -1.0, 20, 10, -1.0], sizes=[1.6, 3.9, 1.56],
        rotations=[0, np.pi / 2], match_threshold=MT, unmatch_threshold=UT,
        class_name="Car")
    return gen.generate([1, 10, 20]).reshape(-1, 7)


def scene(case, rng):
    """(gt (2, 8, 7), valid (2, 8), classes (2, 8)) for a create_target
    case."""
    anchors = grid_anchors()
    gt = np.zeros((2, 8, 7), np.float32)
    gt[..., 0] = rng.uniform(2, 18, (2, 8))
    gt[..., 1] = rng.uniform(-8, 8, (2, 8))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [1.6, 3.9, 1.56]
    gt[..., 6] = rng.choice([0.0, np.pi / 2], (2, 8))
    valid = np.ones((2, 8), bool)
    if case == "no_gt":
        valid[:] = False
        valid[1, :3] = True                  # one sample empty, one not
    elif case == "padded":
        valid[:, 5:] = False
        gt[:, 5:] = 0.0                      # zero-size padding rows
    elif case == "ties":
        # gt on anchor centers, between two anchors, and one rotated by 45
        # degrees: several anchors tie at a gt's best overlap
        gt[:, 0, [0, 1, 6]] = anchors[44, [0, 1, 6]]
        gt[:, 1, :2] = (anchors[44, :2] + anchors[46, :2]) / 2
        gt[:, 2, 6] = np.pi / 4
    return gt, valid, np.ones((2, 8), np.int32)


def jax_targets(anchors, gt, valid, cls, **kw):
    coder = jtarget.GroundBox3dCoder()
    outs = [jtarget.create_target(
        jnp.asarray(anchors), jnp.asarray(gt[i]), jnp.asarray(valid[i]),
        jnp.asarray(cls[i]), jtarget.nearest_iou_similarity, coder.encode,
        MT, UT, 7, **{k: (None if v is None else jnp.asarray(v[i]))
                      for k, v in kw.items()})
            for i in range(gt.shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(3)]


def clear_of_thresholds(anchors, gt, valid, margin=1e-4):
    a = jbox.rbbox2d_to_near_bbox(jnp.asarray(anchors[:, [0, 1, 3, 4, 6]]))
    for i in range(gt.shape[0]):
        g = jbox.rbbox2d_to_near_bbox(jnp.asarray(gt[i][:, [0, 1, 3, 4, 6]]))
        sim = np.asarray(jbox.iou_matrix(a, g))[:, valid[i]]
        for thr in (MT, UT):
            assert not (np.abs(sim - thr) < margin).any()


@pytest.mark.parametrize("case", ["random", "no_gt", "padded", "ties",
                                  "masked"])
def test_create_target_equals_jax(case):
    rng = np.random.RandomState(5)
    anchors = grid_anchors()
    gt, valid, cls = scene(case, rng)
    clear_of_thresholds(anchors, gt, valid)
    amask = rng.uniform(size=(2, anchors.shape[0])) > 0.3 \
        if case == "masked" else None
    ref = jax_targets(anchors, gt, valid, cls, anchors_mask=amask)
    labels, targets, weights = target.create_target(
        t(anchors), t(gt), t(valid), t(cls), target.nearest_iou_similarity,
        GroundBox3dCoder().encode, MT, UT,
        anchors_mask=None if amask is None else t(amask))
    np.testing.assert_array_equal(labels.numpy(), ref[0])
    np.testing.assert_array_equal(weights.numpy(), ref[2])
    np.testing.assert_allclose(targets.numpy(), ref[1], **TOL)
    if case == "no_gt":
        assert (ref[0][0] == 0).all() and (ref[0][1] > 0).any()
    if case == "ties":
        # more positives than anchors past the matched threshold
        sim = np.asarray(jtarget.nearest_iou_similarity(
            jnp.asarray(anchors[:, [0, 1, 3, 4, 6]]),
            jnp.asarray(gt[0][:, [0, 1, 3, 4, 6]])))
        assert (ref[0][0] > 0).sum() > (sim.max(1) >= MT).sum()
    if case == "masked":
        assert (labels.numpy()[~amask] == -1).all()


def test_positive_fraction_subsampling():
    """At most positive_fraction * sample_size positives survive (a subset
    of the unsubsampled ones), at most sample_size - n_fg negatives are
    enabled (drawn with replacement, so a few duplicates), reg weights and
    targets follow the surviving positives; a sample without gt enables
    negatives only; the draws follow the generator."""
    anchors = grid_anchors()
    gt = np.zeros((2, 6, 7), np.float32)
    gt[..., 0] = np.linspace(3, 17, 6)
    gt[..., 1] = np.linspace(-7, 7, 6)
    gt[..., 2] = -1.0
    gt[..., 3:6] = [1.6, 3.9, 1.56]
    valid = np.ones((2, 6), bool)
    valid[1] = False
    cls = np.ones((2, 6), np.int32)
    args = (t(anchors), t(gt), t(valid), t(cls),
            target.nearest_iou_similarity, GroundBox3dCoder().encode, 0.3,
            0.2)
    base = target.create_target(*args)[0]
    assert int((base[0] > 0).sum()) > 4
    sample_size, frac = 32, 0.125
    runs = []
    for seed in (7, 7, 8):
        labels, targets, weights = target.create_target(
            *args, positive_fraction=frac, sample_size=sample_size,
            generator=torch.Generator().manual_seed(seed))
        runs.append(labels)
        n_fg = int((labels[0] > 0).sum())
        n_bg = int((labels[0] == 0).sum())
        assert n_fg == 4
        assert int(0.8 * (sample_size - n_fg)) <= n_bg <= sample_size - n_fg
        assert set(torch.where(labels[0] > 0)[0].tolist()) <= set(
            torch.where(base[0] > 0)[0].tolist())
        assert torch.equal(weights > 0, labels > 0)
        assert (targets[labels <= 0] == 0).all()
        assert (labels[1] <= 0).all()
        assert int(0.8 * sample_size) <= int((labels[1] == 0).sum()) \
            <= sample_size
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])
    assigner = target.TargetAssigner(GroundBox3dCoder(), [],
                                     positive_fraction=-1.0)
    assert assigner.positive_fraction is None


# ---------------------------------------------------------------------------
# assign and the anchor-area mask, in shipped layouts
# ---------------------------------------------------------------------------

def smoke_scene(pc, b=2, g=10, seed=0):
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., 0] = rng.uniform(pc[0] + 2, pc[3] - 2, (b, g))
    gt[..., 1] = rng.uniform(pc[1] + 2, pc[4] - 2, (b, g))
    gt[..., 2] = -1.0
    gt[..., 3:6] = [1.7, 4.1, 1.6]
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    valid = np.ones((b, g), bool)
    valid[:, 7:] = False
    return gt, valid


def two_class_config():
    """The smoke config with a second class (Pedestrian) in its one task:
    two anchor generators, two ids."""
    c = load("smoke_kitti_pointpillars")
    c["tasks"] = [dict(num_class=2, class_names=["Car", "Pedestrian"])]
    c["model"]["bbox_head"]["tasks"] = c["tasks"]
    gens = c["assigner"]["target_assigner"]["anchor_generators"]
    gens.append(dict(gens[0], sizes=[0.6, 0.8, 1.7], matched_threshold=0.35,
                     unmatched_threshold=0.2, class_name="Pedestrian"))
    return c


@pytest.mark.parametrize("name", ["smoke", "two_class"])
def test_assign_equals_jax(name):
    cfg = (load("smoke_kitti_pointpillars") if name == "smoke"
           else two_class_config())
    _, _, asg, cids, _ = build_stack(cfg, device="cpu")
    _, _, jasg, jcids, _ = jbuild_stack(copy.deepcopy(cfg))
    assert cids == jcids
    pc = cfg["voxel_generator"]["range"]
    gt, valid = smoke_scene(pc)
    cls = np.ones(valid.shape, np.int32)
    if name == "two_class":
        cls[:, 1::2] = 2
        gt[:, 1::2, 3:6] = [0.6, 0.8, 1.7]
    labels, targets, weights = asg[0].assign(t(gt), t(cls), t(valid),
                                             class_ids=cids[0])
    for i in range(2):
        ref = jasg[0].assign(jnp.asarray(gt[i]), jnp.asarray(cls[i]),
                             jnp.asarray(valid[i]), class_ids=tuple(cids[0]))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(weights[i].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(targets[i].numpy(), np.asarray(ref[1]),
                                   **TOL)
    assert (labels > 0).sum() > 10
    if name == "two_class":
        assert set(labels.unique().tolist()) == {-1, 0, 1, 2}


def test_anchors_mask_equals_jax():
    """pos_area_threshold >= 0: the anchor-area mask from the device
    voxels of structured scans, equal to JAX's; targets through
    build_example with the mask equal to JAX's."""
    from det3d_tpu_torch.utils.synth import structured_batch
    cfg = load("smoke_kitti_pointpillars")
    cfg["assigner"]["target_assigner"]["pos_area_threshold"] = 1
    _, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    _, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(cfg))
    pc = cfg["voxel_generator"]["range"]
    batch = structured_batch(2, 3000, pc, seed=4)
    gt, valid = smoke_scene(pc, seed=1)
    batch.update(gt_boxes=gt, gt_valid=valid,
                 gt_classes=np.ones(valid.shape, np.int32))
    ex = build_example({k: t(v) for k, v in batch.items()}, vg, asg, cids,
                       with_targets=True)
    jex = jax.jit(lambda b: jbuild_example(b, jvg, jasg, jcids))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    mask = ex["anchors_mask"][0].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jex["anchors_mask"][0]))
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(ex["labels"][0].numpy(),
                                  np.asarray(jex["labels"][0]))
    assert (ex["labels"][0].numpy()[~mask] == -1).all()


# ---------------------------------------------------------------------------
# losses and the head's loss
# ---------------------------------------------------------------------------

LOSS_CFGS = [
    dict(type="WeightedSmoothL1Loss", sigma=3.0, codewise=True),
    dict(type="WeightedSmoothL1Loss", sigma=1.0, codewise=False),
    dict(type="WeightedL2LocalizationLoss"),
    dict(type="SigmoidFocalLoss", alpha=0.25, gamma=2.0),
    dict(type="SigmoidFocalLoss", alpha=None, gamma=0.0),
    dict(type="WeightedSigmoidClassificationLoss"),
    dict(type="WeightedSoftmaxClassificationLoss", logit_scale=2.0),
]


@pytest.mark.parametrize("cfg", LOSS_CFGS, ids=lambda c: c["type"])
def test_loss_equals_jax(cfg):
    rng = np.random.RandomState(len(str(cfg)))
    pred = rng.normal(0, 2, (2, 50, 3)).astype(np.float32)
    if "Classification" in cfg["type"] or "Focal" in cfg["type"]:
        target_ = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 50))]
    else:
        target_ = rng.normal(0, 1, (2, 50, 3)).astype(np.float32)
    weights = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    out = losses.build_loss(cfg)(t(pred), t(target_), weights=t(weights))
    ref = jlosses.build_loss(cfg)(jnp.asarray(pred), jnp.asarray(target_),
                                  weights=jnp.asarray(weights))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", ["NormByNumPositives", "NormByNumExamples",
                                  "NormByNumPosNeg", "DontNorm"])
def test_prepare_loss_weights_equals_jax(norm):
    rng = np.random.RandomState(6)
    labels = rng.choice([-1, 0, 0, 0, 1, 2], (3, 40))
    labels[2] = -1                           # nothing cared for
    cfg = dict(type=norm, pos_cls_weight=2.0, neg_cls_weight=0.5)
    out = heads.prepare_loss_weights(t(labels), cfg)
    ref = jheads.prepare_loss_weights(jnp.asarray(labels), cfg)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_direction_target_equals_jax():
    rng = np.random.RandomState(7)
    anchors = boxes(rng, 100)[None]
    reg = rng.normal(0, 1, (1, 100, 7)).astype(np.float32)
    for off in (0.0, 0.785):
        for oh in (True, False):
            out = heads.get_direction_target(t(anchors), t(reg), off, oh)
            ref = jheads.get_direction_target(jnp.asarray(anchors),
                                              jnp.asarray(reg), off, oh)
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


HEAD_KEYS = ("loss", "cls_pos_loss", "cls_neg_loss", "dir_loss_reduced",
             "cls_loss_reduced", "loc_loss_reduced", "loc_loss_elem",
             "num_pos", "num_neg")


@pytest.mark.parametrize("variant", ["smoke", "vector_two_tasks"])
def test_head_loss_equals_jax(variant):
    """MultiGroupHead.loss on random predictions and assigned targets:
    the same keys as JAX's, every value within 1e-5. ``vector_two_tasks``:
    two tasks, a 9-dim coder with vector angles, no direction classifier,
    NormByNumPosNeg and background as a class."""
    cfg = load("smoke_kitti_pointpillars")
    if variant == "vector_two_tasks":
        tasks = [dict(num_class=1, class_names=["Car"]),
                 dict(num_class=1, class_names=["Van"])]
        coder = dict(type="ground_box3d_coder", n_dim=9, linear_dim=False,
                     encode_angle_vector=True)
        gens = cfg["assigner"]["target_assigner"]["anchor_generators"]
        gens[0]["velocities"] = [0.0, 0.0]
        gens.append(dict(gens[0], class_name="Van"))
        cfg["tasks"] = tasks
        cfg["assigner"]["box_coder"] = coder
        cfg["model"]["bbox_head"].update(
            tasks=tasks, box_coder=coder, loss_aux=None,
            encode_background_as_zeros=False,
            loss_norm=dict(type="NormByNumPosNeg", pos_cls_weight=1.5,
                           neg_cls_weight=1.0))
    model, _, asg, cids, _ = build_stack(cfg, device="cpu")
    pc = cfg["voxel_generator"]["range"]
    nd = 9 if variant == "vector_two_tasks" else 7
    gt7, valid = smoke_scene(pc, seed=2)
    gt = np.zeros(gt7.shape[:2] + (nd,), np.float32)
    gt[..., :6], gt[..., -1] = gt7[..., :6], gt7[..., -1]
    cls = np.ones(valid.shape, np.int32)
    cls[:, 1::2] = len(cids)
    ex = {"anchors": [], "labels": [], "reg_targets": [], "reg_weights": []}
    preds, jpreds = [], []
    rng = np.random.RandomState(8)
    for a, ids, head in zip(asg, cids,
                            [getattr(model.bbox_head, f"task_{i}")
                             for i in range(len(asg))]):
        lab, tgt, w = a.assign(t(gt), t(cls), t(valid), class_ids=ids)
        anchors = a.anchors_on("cpu")
        ex["anchors"].append(anchors[None].expand(2, *anchors.shape))
        ex["labels"].append(lab)
        ex["reg_targets"].append(tgt)
        ex["reg_weights"].append(w)
        h, w_ = 100, 100
        p = {"box_preds": rng.normal(0, 0.3, (2, h, w_,
                                              head.conv_box.out_channels)),
             "cls_preds": rng.normal(-2, 1, (2, h, w_,
                                             head.conv_cls.out_channels))}
        if head.conv_dir is not None:
            p["dir_cls_preds"] = rng.normal(0, 1, (2, h, w_,
                                                   head.conv_dir.out_channels))
        p = {k: v.astype(np.float32) for k, v in p.items()}
        preds.append({k: t(v) for k, v in p.items()})
        jpreds.append({k: jnp.asarray(v) for k, v in p.items()})
    out = model.loss(ex, preds)
    jmodel = jbuild_stack(copy.deepcopy(cfg))[0]
    jex = {k: [jnp.asarray(v.numpy()) for v in vs] for k, vs in ex.items()}
    ref = jmodel.bbox_head.loss(jex, jpreds)
    assert sorted(out) == sorted(ref) == sorted(HEAD_KEYS)
    for k in HEAD_KEYS:
        for o, r in zip(out[k], ref[k]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL,
                                       err_msg=k)
    assert all(int(n) > 0 for n in out["num_pos"])
