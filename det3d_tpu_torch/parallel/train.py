"""The train step and the validation-loss step, and the example both
build: points -> voxels -> anchors and targets.

Port of det3d_tpu/parallel/train.py: ``TrainState``, ``build_example``
(voxelization, each task's anchors, the anchor-area mask and, with
``with_targets``, target assignment), ``make_train_step`` and
``make_loss_eval_step``. The mesh becomes ranks: see "Ranks" below.

The JAX train step is one jitted function of (state, batch); here the
model holds the parameters and BatchNorm statistics and the optimizer
(solver/optim.py) its moments and step count, all on the model's device.
``train_step(batch) -> metrics`` voxelizes, assigns targets, runs the
network in training mode (BatchNorm on batch statistics, running
statistics updated), computes the head's losses, takes their gradients
with ``torch.autograd.grad`` and applies the optimizer's update. On the
card it is a ``CapturedStep`` (parallel/graph.py): the whole step,
backward and update included, replays as one CUDA graph a batch
signature; the learning rate and momentum come from the optimizer's
count on the device. A sparse middle trains from the batch's host
training plan (``plan_*`` keys, apis/train.py::host_plan_fn(train=True))
or, without one, from the training plan it builds on the device; its
window convs' backward runs the kernels of ops/window_conv_cuda.py.

Ranks (torch.distributed, parallel/dist_utils.py): while a process group
is up, each rank steps on its own B/W examples and the step is the JAX
package's global step over the W ranks' batches concatenated in rank
order (det3d_tpu/parallel/train.py:14-21; the mesh's one program over
the whole batch): the BatchNorm statistics are every rank's
(models/norm.py), the gradients of each rank's loss are summed over the
ranks as one flat buffer and divided by W, the gradient of the mean of
the ranks' losses, which is the global batch's loss (each task's losses
are sums over examples over the batch size), before the optimizer's
update, so that its global-norm clip and ``grad_norm`` see the global
gradient and every rank applies the same update; no
DistributedDataParallel, whose hooks ``torch.autograd.grad`` would not
fire. The metrics are the global batch's: the losses and ``num_voxels``
are means over the ranks, ``num_pos`` / ``num_neg`` rank 0's, as the
JAX package counts them on the global batch's first example, rank 0's
first (det3d_tpu/models/heads.py:264). Under NCCL the step is captured
as on one card; under gloo it runs eagerly (parallel/graph.py::stepper).

Batch layout (numpy arrays or tensors):
  points (B, P, C) float32, num_points (B,) int32,
  gt_boxes (B, G, nd) float32, gt_classes (B, G) int32 (global 1-based
  ids), gt_valid (B, G) bool; host voxels as the predict step takes them,
  and a sparse middle's host plan.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from det3d_tpu_torch.core.target import TargetAssigner
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.parallel import dist_utils
from det3d_tpu_torch.parallel.graph import stepper
from det3d_tpu_torch.utils import trace

METRIC_KEYS = ("loc_loss_reduced", "cls_loss_reduced", "dir_loss_reduced",
               "cls_pos_loss", "cls_neg_loss", "num_pos", "num_neg")


class TrainState:
    """What a train step advances: ``model`` (parameters and BatchNorm
    statistics) and ``tx`` (solver/optim.py::Optimizer: moments and the
    step count, ``step``)."""

    def __init__(self, model, tx):
        self.model, self.tx = model, tx

    @property
    def step(self) -> torch.Tensor:
        return self.tx.count

    def tensors(self):
        """Every tensor the step updates in place."""
        return (list(self.model.parameters()) + list(self.model.buffers())
                + self.tx.state_tensors())


def build_example(batch: Dict[str, Any], voxel_generator: VoxelGenerator,
                  assigners: Sequence[TargetAssigner],
                  class_ids_per_task: Optional[Sequence[Sequence[int]]] = None,
                  with_targets: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, Any]:
    """Voxelize the batch (unless it already carries ``voxels``, the host
    voxelized serving input), attach each task's anchors broadcast over the
    batch, the anchor-area masks where an assigner sets
    ``anchor_area_threshold >= 0`` and, with ``with_targets``, each task's
    ``labels``, ``reg_targets`` and ``reg_weights`` from the batch's padded
    gt (``class_ids_per_task``: each task's global class ids;
    ``generator``: the draws of positive_fraction subsampling). The
    batch's ``plan_*`` keys go into ``example["plan"]`` without their
    prefix (a sparse middle's host plan; absent without them). All tensors
    must be on one device."""
    if "voxels" in batch:
        vox = {"voxels": batch["voxels"], "coords": batch["coordinates"],
               "num_points_per_voxel": batch["num_points_per_voxel"],
               "num_voxels": batch["num_voxels"]}
    else:
        with trace.segment("voxelize"):
            vox = voxel_generator.generate_batch(batch["points"],
                                                 batch["num_points"])
    points = batch["points"]
    b = points.shape[0]
    example: Dict[str, Any] = {
        "voxels": vox["voxels"],
        "coordinates": vox["coords"],
        "num_points_per_voxel": vox["num_points_per_voxel"],
        "num_voxels": vox["num_voxels"],
        "anchors": [],
    }
    plan = {k[5:]: v for k, v in batch.items() if k.startswith("plan_")}
    if plan:
        example["plan"] = plan
    if with_targets:
        example.update({"labels": [], "reg_targets": [], "reg_weights": []})
    use_amask = any(a.anchor_area_threshold >= 0 for a in assigners)
    if use_amask:
        example["anchors_mask"] = []

    with trace.segment("targets") if with_targets or use_amask \
            else contextlib.nullcontext():
        for t, assigner in enumerate(assigners):
            anchors = assigner.anchors_on(points.device)
            example["anchors"].append(anchors[None].expand(b,
                                                           *anchors.shape))
            amask = None
            if assigner.anchor_area_threshold >= 0:
                amask = assigner.anchors_mask(vox["coords"],
                                              voxel_generator.grid_size)
            if use_amask:
                example["anchors_mask"].append(amask)
            if with_targets:
                labels, targets, weights = assigner.assign(
                    batch["gt_boxes"], batch["gt_classes"],
                    batch["gt_valid"],
                    class_ids=tuple(class_ids_per_task[t]),
                    generator=generator, anchors_mask=amask)
                example["labels"].append(labels)
                example["reg_targets"].append(targets)
                example["reg_weights"].append(weights)
    return example


@contextlib.contextmanager
def _mode(model, training: bool):
    """The model in training (batch statistics) or eval mode, restored
    after."""
    was = model.training
    model.train(training)
    try:
        yield
    finally:
        model.train(was)


def network_loss(model, example):
    """The head's losses on the example, and their total. The example's
    plan, where it has one, goes to the model's sparse middle."""
    kw = {"plan": example["plan"]} if "plan" in example else {}
    preds = model(example["voxels"], example["num_points_per_voxel"],
                  example["coordinates"], **kw)
    with trace.segment("loss"):
        losses = model.loss(example, preds)
        return sum(losses["loss"]), losses


def mean_over_ranks(tensors):
    """Each tensor's mean over the ranks: one all-reduce of their flat
    concatenation, divided by the world size."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(flat)
    flat = flat / torch.distributed.get_world_size()
    return [v.view_as(t) for t, v in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each rank's 0-d fp32 ones, in one
    all-reduce: the means over the ranks, and ``num_pos*`` / ``num_neg*``
    rank 0's (every other rank contributes zero to the sum)."""
    keys = sorted(metrics)
    rank, world = dist_utils.get_dist_info()
    first = [k.startswith(("num_pos", "num_neg")) for k in keys]
    vec = torch.stack([metrics[k] * (0.0 if f and rank else 1.0)
                       for k, f in zip(keys, first)])
    torch.distributed.all_reduce(vec)
    return {k: v if f else v / world
            for k, v, f in zip(keys, vec.unbind(), first)}


def make_train_step(state: TrainState, voxel_generator: VoxelGenerator,
                    assigners: Sequence[TargetAssigner],
                    class_ids_per_task: Sequence[Sequence[int]],
                    generator: Optional[torch.Generator] = None) -> Callable:
    """Returns ``train_step(batch) -> metrics``: one optimizer step of
    ``state`` (apis/train.py::init_state) on the batch. Metrics, 0-d fp32
    tensors: ``loss`` (the sum over tasks), ``grad_norm`` (the gradients'
    global norm before clipping), ``num_voxels`` (the batch mean) and
    ``{key}_task{t}`` for each of METRIC_KEYS.

    On a CUDA model the step is a CapturedStep (``train_step.eager`` the
    same step run eagerly; the capture's warm-up leaves the state as it
    was), eager under gloo ranks (parallel/graph.py::stepper); on a CPU
    model (the caller asked for the CPU) it runs eagerly.

    While a process group is up, each rank's call is its share of the
    global step (see the module's docstring; every rank calls it with
    its batch, in step). ``generator``: the draws of positive_fraction
    subsampling (core/target.py::create_target), where rank r's example
    i draws as the global batch's example r * B + i; no shipped config
    subsamples, and their steps draw nothing.

    While tracing is on (utils/trace.py) the step enters the segments
    voxelize, targets, the detector's stages (as the predict step), loss,
    backward (the all-reduce of ranks included) and optimizer."""
    model, tx = state.model, state.tx
    params = list(model.parameters())
    device = params[0].device
    ranks = dist_utils.active()
    trace.stage_hooks(model)

    def run(batch):
        with torch.no_grad():
            example = build_example(batch, voxel_generator, assigners,
                                    class_ids_per_task, with_targets=True,
                                    generator=generator)
        with _mode(model, True), torch.enable_grad():
            total, losses = network_loss(model, example)
            with trace.segment("backward"):
                grads = torch.autograd.grad(total, params)
                if ranks:
                    grads = mean_over_ranks(grads)
        with trace.segment("optimizer"):
            grad_norm = tx.update(grads)
        metrics = {"loss": total.detach(),
                   "num_voxels": example["num_voxels"].float().mean()}
        for k in METRIC_KEYS:
            for t, v in enumerate(losses[k]):
                metrics[f"{k}_task{t}"] = v.detach().float()
        if ranks:
            metrics = global_metrics(metrics)
        metrics["grad_norm"] = grad_norm
        return metrics

    return stepper(run, device, state.tensors, collective=ranks)


def make_loss_eval_step(model, voxel_generator: VoxelGenerator,
                        assigners: Sequence[TargetAssigner],
                        class_ids_per_task: Sequence[Sequence[int]]
                        ) -> Callable:
    """Returns ``loss_step(batch) -> {"loss": tensor}``: the validation
    loss with BatchNorm on its running statistics, nothing updated (the
    reference workflow's ``('val', 1)``), from the batch's host plan where
    it has one. Captured on a CUDA model (eager under gloo ranks). While a
    process group is up the loss is the mean over the ranks' batches."""
    device = next(model.parameters()).device
    ranks = dist_utils.active()

    @torch.no_grad()
    def run(batch):
        example = build_example(batch, voxel_generator, assigners,
                                class_ids_per_task, with_targets=True)
        with _mode(model, False):
            out = {"loss": network_loss(model, example)[0]}
        return global_metrics(out) if ranks else out

    return stepper(run, device, collective=ranks)
