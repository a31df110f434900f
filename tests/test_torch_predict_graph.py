"""The predict step as CUDA graphs (parallel/graph.py::CapturedStep), the
counterpart of the JAX package's ``jax.jit(step_fn)``, and what a capture
needs of the step.

On the CPU: the eager step of each of the seven serving paths, at cut
sizes, makes no tensor from host data and reads no device value back
(checked under a dispatch mode, the kernels' plain versions excepted: on
the card the kernels replace them), fed as it is served from host data,
from points alone (device voxels and plans) and with double-flip TTA; a
CPU model gets the eager step. The same lint holds the pillar paths'
train step (parallel/train.py: target assignment, forward, backward and
the optimizer's update) and its loss-eval step.

On the card (marker ``cuda``; they skip elsewhere from a fixture, so that
every worker collects the same tests; run them with
``python -m pytest tests/test_torch_predict_graph.py -m cuda -q``): the
captured step against the eager step on the same batch (valid masks and
labels equal, boxes and scores within DET_TOL = 1e-5 absolute, as
chip_smoke.py's decode gate), a second batch of the same signature
replayed without a new capture, a new signature captured anew, outputs
that a later call does not overwrite, a capture that fails raising, and
one eager step on device inputs under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack, host_plan_fn
from det3d_tpu_torch.models import backbones
from det3d_tpu_torch.models.builder import init_weights
from det3d_tpu_torch.ops import nms as nms_ops
from det3d_tpu_torch.parallel.graph import CapturedStep
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils.synth import structured_batch

torch.set_num_threads(2)

FLAGSHIP_PC = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
CUT = (6.4, 512)            # sparse middles: +-6.4 m, 512 voxels
PATHS = ("flagship", "second", "kitti_all", "cbgs", "lyft", "kitti_pp",
         "nusc_pp")


def path_config(name):
    """A serving path's config at a cut size, every width as shipped."""
    if name == "flagship":
        return flagship_config(voxel_size=(0.2, 0.2, 4.0),
                               pc_range=FLAGSHIP_PC, max_points=8,
                               max_voxels=600, small=True)
    if name in ("kitti_pp", "nusc_pp"):
        c = cs.pp_config(cs.KITTI_PP_CFG if name == "kitti_pp"
                         else cs.NUSC_PP_CFG, cut=True)
        c["voxel_generator"]["max_voxel_num"] = 600
        return c
    path = {"second": cs.SECOND_CFG, "kitti_all": cs.KITTI_ALL_CFG,
            "cbgs": cs.CBGS_CFG, "lyft": cs.LYFT_CFG}[name]
    return cs.sparse_config(path, cut=CUT)


# how a step is fed: from host voxels and plans where the path serves
# from them, from points alone, or from points with double-flip TTA
FEEDS = ("host", "points", "tta")


def path_step(name, device, points=2000, b=2, seed=3, pre_max=None,
              feed="host"):
    """(predict step, batch: the scans, with their host voxels and plan
    when ``feed`` is "host") of a path at its cut size on ``device``,
    weights from torch.Generator().manual_seed(0)."""
    cfg = path_config(name)
    if pre_max is not None:
        cfg["test_cfg"]["nms"]["nms_pre_max_size"] = pre_max
    cfg["test_cfg"]["double_flip"] = feed == "tta"
    model, vg, asg, cids, test_cfg = build_stack(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    pc = cfg["voxel_generator"]["range"]
    five = (cfg["model"]["reader"].get("num_input_features", 4) == 5
            or name in ("cbgs", "lyft"))
    batch = (cs.cbgs_batch(b, points, pc, seed=seed) if five
             else structured_batch(b, points, pc, seed=seed))
    fn = host_plan_fn(model, vg, voxelize=True)
    if name not in ("flagship", "kitti_pp") and feed == "host":
        batch.update(fn(batch["points"], batch["num_points"]))
    return make_predict_step(model, vg, asg, cids, test_cfg), batch


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

# host data made a tensor (on the card: a copy from pageable memory and a
# wait), a device value read on the host, data-dependent shapes
HOST_ROUND_TRIPS = ("aten.lift_fresh", "aten._local_scalar_dense",
                    "aten.nonzero", "aten.masked_select", "aten.equal",
                    "aten.is_nonzero", "aten.unique", "aten._unique",
                    "aten.repeat_interleave.Tensor")


class HostRoundTrips(TorchDispatchMode):
    """Records the operations of HOST_ROUND_TRIPS, and indexing by a bool
    mask (a nonzero inside), except while ``paused``."""

    def __init__(self):
        super().__init__()
        self.found, self.paused = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not self.paused:
            if name.startswith(HOST_ROUND_TRIPS):
                self.found.append(name)
            if name.startswith("aten.index") and any(
                    isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for a in args if isinstance(a, (list, tuple))
                    for t in a):
                self.found.append(name + " (bool mask)")
        return func(*args, **(kwargs or {}))


def pausing(mode, fn):
    def wrapped(*a, **k):
        mode.paused += 1
        try:
            return fn(*a, **k)
        finally:
            mode.paused -= 1
    return wrapped


def no_host_round_trip(name, monkeypatch, feed="host"):
    step, batch = path_step(name, "cpu", pre_max=100, feed=feed)
    data = {k: torch.as_tensor(v) for k, v in batch.items()}
    step.eager(data)
    mode = HostRoundTrips()
    monkeypatch.setattr(nms_ops, "rotated_nms_keep",
                        pausing(mode, nms_ops.rotated_nms_keep))
    monkeypatch.setattr(backbones, "window_conv",
                        pausing(mode, backbones.window_conv))
    with mode:
        out = step.eager(data)
    assert not mode.found, sorted(set(mode.found))
    assert bool(torch.isfinite(out["box3d_lidar"]).all())


@pytest.mark.parametrize("name", PATHS)
def test_step_makes_no_host_round_trip(name, monkeypatch):
    """After one call (which copies the anchors to the device once), the
    eager step makes no tensor from host data and reads no device value:
    what a CUDA graph could not capture. The kernels' plain versions are
    left out (the NMS twin's greedy loop tests for its fixpoint)."""
    no_host_round_trip(name, monkeypatch)


# the steps that voxelize and build their plans on the device: the sparse
# paths from points alone, and double-flip TTA
DEVICE_FED = ([(n, "points") for n in ("second", "kitti_all", "cbgs",
                                       "lyft")]
              + [(n, "tta") for n in ("cbgs", "nusc_pp", "second",
                                      "flagship")])


@pytest.mark.parametrize("name,feed", DEVICE_FED)
def test_device_fed_step_makes_no_host_round_trip(name, feed, monkeypatch):
    """test_step_makes_no_host_round_trip for the steps fed points alone:
    the device voxelizer, the device rulebook builders and the TTA merge
    make no host round trip either."""
    no_host_round_trip(name, monkeypatch, feed)


# the pillar paths' train step and validation-loss step
# (parallel/train.py), with kitti_car_pointpillars.py's optimizer
TRAIN_CFG = dict(optimizer=dict(TYPE="adam", VALUE=dict(amsgrad=0.0,
                                                        wd=0.01),
                                FIXED_WD=True),
                 lr_config=dict(type="one_cycle", lr_max=0.003,
                                moms=[0.95, 0.85], div_factor=10.0,
                                pct_start=0.4))


def train_steps(name, device, feed="points"):
    """(train step, loss-eval step, training scans, train state) of a
    pillar path, or of SECOND, at its cut size on ``device``, weights from
    torch.Generator().manual_seed(0); SECOND's scans carry their host
    training plan and voxels when ``feed`` is "host"."""
    from det3d_tpu_torch.apis.train import init_state
    from det3d_tpu_torch.parallel.train import (make_loss_eval_step,
                                                make_train_step)
    cfg = dict(path_config(name), **TRAIN_CFG)
    model, vg, asg, cids, _ = build_stack(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    state, _ = init_state(cfg, model, 20)
    scans = cs.train_scene(2, 2000, cfg["voxel_generator"]["range"])
    if feed == "host":
        scans.update(host_plan_fn(model, vg, train=True, voxelize=True)(
            scans["points"], scans["num_points"]))
    return (make_train_step(state, vg, asg, cids),
            make_loss_eval_step(model, vg, asg, cids), scans, state)


@pytest.mark.parametrize("name,feed", [("flagship", "points"),
                                       ("kitti_pp", "points"),
                                       ("second", "host"),
                                       ("second", "points")])
def test_train_step_makes_no_host_round_trip(name, feed, monkeypatch):
    """test_step_makes_no_host_round_trip for the train step (target
    assignment, forward, backward, the clip, the schedules and the
    optimizer's update on the device count) and the loss-eval step; for
    SECOND from its host training plan and from points (the device
    training plan), the window conv's plain versions left out."""
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    train, loss_eval, scans, _ = train_steps(name, "cpu", feed)
    data = {k: torch.as_tensor(v) for k, v in scans.items()}
    train.eager(data)
    loss_eval.eager(data)
    mode = HostRoundTrips()
    for fn in ("_forward", "window_conv_dw", "window_conv_inv"):
        monkeypatch.setattr(wc, fn, pausing(mode, getattr(wc, fn)))
    with mode:
        metrics = train.eager(data)
        loss = loss_eval.eager(data)
    assert not mode.found, sorted(set(mode.found))
    assert bool(torch.isfinite(metrics["loss"])) and bool(
        torch.isfinite(loss["loss"]))


def test_cpu_model_gets_the_eager_step():
    step, batch = path_step("flagship", "cpu", pre_max=100)
    assert not isinstance(step, CapturedStep)
    assert step.eager is step
    out = step(batch)
    assert out["box3d_lidar"].shape == (2, 100, 7)


def test_signature_keys_shapes_dtypes():
    a = {"points": np.zeros((2, 5, 4), np.float32),
         "num_points": np.zeros(2, np.int32)}
    b = {"num_points": torch.zeros(2, dtype=torch.int32),
         "points": torch.ones(2, 5, 4)}
    sig = CapturedStep.signature(CapturedStep.tensors(a))
    assert sig == CapturedStep.signature(CapturedStep.tensors(b))
    assert sig != CapturedStep.signature(CapturedStep.tensors(
        dict(a, points=np.zeros((2, 6, 4), np.float32))))
    assert sig != CapturedStep.signature(CapturedStep.tensors(
        dict(a, num_points=np.zeros(2, np.int64))))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def assert_detections_agree(out, ref):
    """Valid masks and labels equal; boxes and scores within cs.DET_TOL."""
    for k in ("valid", "label_preds"):
        assert torch.equal(out[k].cpu(), ref[k].cpu()), k
    for k in ("box3d_lidar", "scores"):
        torch.testing.assert_close(out[k].cpu(), ref[k].cpu(), rtol=0,
                                   atol=cs.DET_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PATHS)
def test_captured_step_equals_eager(dev, name):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    step, batch = path_step(name, dev)
    assert isinstance(step, CapturedStep)
    window_conv.launches = rotated_nms_keep.launches = 0
    ref = step.eager(batch)
    eager = (window_conv.launches, rotated_nms_keep.launches)
    step.warm_up(batch)
    window_conv.launches = rotated_nms_keep.launches = 0
    step.capture(batch)
    assert (window_conv.launches, rotated_nms_keep.launches) == eager
    out = step(batch)
    assert (window_conv.launches, rotated_nms_keep.launches) == eager
    assert_detections_agree(out, ref)
    assert int(out["valid"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,feed", DEVICE_FED)
def test_device_fed_captured_step_equals_eager(dev, name, feed):
    """test_captured_step_equals_eager, and a sync-free eager step, for the
    steps fed points alone."""
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    step, batch = path_step(name, dev, feed=feed)
    data = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    window_conv.launches = rotated_nms_keep.launches = 0
    ref = step.eager(data)
    eager = (window_conv.launches, rotated_nms_keep.launches)
    assert eager[1] == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.eager(data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    step.warm_up(batch)
    window_conv.launches = rotated_nms_keep.launches = 0
    step.capture(batch)
    assert (window_conv.launches, rotated_nms_keep.launches) == eager
    assert_detections_agree(step(batch), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PATHS)
def test_eager_step_never_synchronizes(dev, name):
    step, batch = path_step(name, dev)
    data = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    step.eager(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.eager(data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "second"])
def test_same_signature_replays_new_signature_captures(dev, name):
    """A second batch of the same shapes replays the graph (its own
    detections, not the first batch's); a batch of other shapes captures a
    second graph; host arrays and device tensors share a signature."""
    step, first = path_step(name, dev, seed=3)
    second = path_step(name, "cpu", seed=11)[1]
    out1 = step(first)
    assert len(step.graphs) == 1
    out2 = step(second)
    assert len(step.graphs) == 1
    assert_detections_agree(out2, step.eager(second))
    assert not torch.equal(out1["box3d_lidar"], out2["box3d_lidar"])
    assert_detections_agree(out1, step.eager(first))
    step({k: torch.as_tensor(v, device=dev) for k, v in first.items()})
    assert len(step.graphs) == 1
    other = path_step(name, "cpu", points=1500, seed=5)[1]
    out3 = step(other)
    assert len(step.graphs) == 2
    assert_detections_agree(out3, step.eager(other))


@pytest.mark.cuda
def test_outputs_survive_later_calls(dev):
    step, first = path_step("flagship", dev, seed=3)
    second = path_step("flagship", "cpu", seed=11)[1]
    out1 = step(first)
    kept = {k: v.clone() for k, v in out1.items()}
    step(second)
    for k in kept:
        assert torch.equal(out1[k], kept[k]), k


@pytest.mark.cuda
def test_failed_capture_raises(dev):
    """A step that reads a device value on the host cannot be captured:
    the capture raises, and nothing runs eagerly in its place."""
    def run(batch):
        x = batch["x"] * 2
        return {"y": x * float(x.sum())}
    step = CapturedStep(run, dev)
    batch = {"x": np.ones(4, np.float32)}
    step.warm_up(batch)
    with pytest.raises(RuntimeError):
        step.capture(batch)
    assert not step.graphs


# the captured train step against the eager one: two copies of one model
CAPTURED_TRAIN_STEPS = 4
CAPTURED_TRAIN_REL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "kitti_pp"])
def test_captured_train_step_follows_eager(dev, name):
    """One copy of a pillar path's model trained by the eager step, one by
    the captured step (one graph, captured once; its warm-up leaves the
    state as it was), on the same batch: after CAPTURED_TRAIN_STEPS steps
    every parameter within a relative L2 of CAPTURED_TRAIN_REL (a backward
    may sum in another order from one replay to the next), the step counts
    equal; the eager step, after its first call, never waits for the
    card. The loss-eval step's captured loss equals its eager one."""
    eager, _, scans, s_eager = train_steps(name, dev)
    captured, loss_eval, _, s_captured = train_steps(name, dev)
    data = {k: torch.as_tensor(v, device=dev) for k, v in scans.items()}
    for i in range(CAPTURED_TRAIN_STEPS):
        if i:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            eager.eager(data)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out = captured(scans)
        assert len(captured.graphs) == 1
        assert bool(torch.isfinite(out["loss"]))
    assert int(s_eager.step) == int(s_captured.step) == CAPTURED_TRAIN_STEPS
    for a, b in zip(s_eager.tensors(), s_captured.tensors()):
        if a.dtype.is_floating_point:
            err = float((a - b).float().norm())
            assert err <= CAPTURED_TRAIN_REL * float(a.float().norm()), err
        else:
            assert torch.equal(a, b)
    ref = loss_eval.eager(data)["loss"]
    assert torch.allclose(loss_eval(scans)["loss"], ref, rtol=1e-5, atol=0)
