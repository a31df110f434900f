"""Build the stack from a config, the host plans it serves from, and the
train state.

Port of det3d_tpu/apis/train.py: ``build_stack`` (the same
reference-schema config -- ``voxel_generator``, ``model``, ``assigner``,
``tasks``, ``test_cfg`` -- builds the voxelizer, the detector, the per-task
assigners and the class ids), ``host_plan_fn`` (the sparse middle's
rulebooks and the voxels, built on the host for each request batch) and
``init_state`` (the optimizer and schedules of ``optimizer`` and
``lr_config``, for parallel/train.py::make_train_step). The trainer, the
datasets and ``train_detector`` / ``eval_detector`` are ROADMAP queue 1's
later items.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from det3d_tpu_torch.core.anchors import build_box_coder
from det3d_tpu_torch.core.target import build_target_assigners
from det3d_tpu_torch.core.voxelize import VoxelGenerator
from det3d_tpu_torch.models.backbones import middle_plan_spec
from det3d_tpu_torch.models.builder import build_detector
from det3d_tpu_torch.ops import sparse_host as sph
from det3d_tpu_torch.ops.voxelize_host import (host_voxelize,
                                               host_voxelize_ref,
                                               stack_voxels)
from det3d_tpu_torch.parallel.train import TrainState
from det3d_tpu_torch.solver.optim import build_optimizer
from det3d_tpu_torch.solver.schedules import build_lr_schedule


def host_plan_fn(model, voxel_gen, train: bool = False,
                 voxelize: bool = False):
    """A callable that builds the packed host rulebook plans of a numpy
    batch: ``fn(points (B, P, C), num_points (B,)) -> {key: (B, ...)}``.

    Returns None when the model has no sparse middle (or the voxelizer's
    order has no host twin) and ``voxelize`` is False. ``voxelize=True``
    also voxelizes on the host (ops/voxelize_host.py): the result carries
    the example's ``voxels`` / ``coordinates`` / ... keys, which the
    predict step takes as they are, and no ``point_lin`` / ``point_perm``.
    The serving process calls it in its request pre-processing, outside
    the device step, and a trainer in its input pipeline. The builders are
    the C++ twins of csrc/hostplan.cc (built with g++ at first use).
    ``train=True`` adds each strided conv's inverse rulebook
    (``plan_inv{i}``), which the train step's backward reads."""
    return _plan_fn(model, voxel_gen, voxelize, train, sph.build_plan,
                    host_voxelize)


def host_plan_ref_fn(model, voxel_gen, train: bool = False,
                     voxelize: bool = False):
    """``host_plan_fn`` with the numpy builders, the plain versions
    (``ops/sparse_host.py::build_plan_ref``,
    ``ops/voxelize_host.py::host_voxelize_ref``): the same arrays. The
    tests and chip_smoke.py hold ``host_plan_fn`` to it."""
    return _plan_fn(model, voxel_gen, voxelize, train, sph.build_plan_ref,
                    host_voxelize_ref)


def _plan_fn(model, voxel_gen, voxelize, train, build_plan, voxelize_one):
    backbone = getattr(model, "backbone", None)
    sparse_mid = ("SpMiddle" in type(backbone).__name__
                  and voxel_gen.effective_order in ("hashed", "yxz"))
    vkw = voxel_gen.host_kwargs()
    if not sparse_mid:
        if not voxelize:
            return None

        def vox_fn(points, num_points):
            points = np.asarray(points)
            num_points = np.asarray(num_points)
            return stack_voxels([voxelize_one(points[i], num_points[i], **vkw)
                                 for i in range(points.shape[0])])

        return vox_fn
    spec = middle_plan_spec(backbone, voxel_gen.grid_size,
                            voxel_gen.max_voxels)
    kw = dict(voxel_size=tuple(voxel_gen.voxel_size),
              pc_range=tuple(voxel_gen.point_cloud_range),
              grid_size=tuple(voxel_gen.grid_size),
              max_voxels=int(voxel_gen.max_voxels),
              order=voxel_gen.effective_order, spec=spec, train=train)

    def fn(points, num_points):
        points = np.asarray(points)
        num_points = np.asarray(num_points)
        plans = [build_plan(points[i], num_points[i], **kw)
                 for i in range(points.shape[0])]
        out = {k: np.stack([p[k] for p in plans]) for k in plans[0]}
        if voxelize:
            # the plan already owns lin/perm: voxelize without resorting
            out.update(stack_voxels([
                voxelize_one(points[i], num_points[i], lin=p["point_lin"],
                             perm=p["point_perm"], **vkw)
                for i, p in enumerate(plans)]))
            out.pop("point_lin")
            out.pop("point_perm")
        return out

    return fn


def _device(device) -> torch.device:
    """The model's device; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_stack: device 'cuda' asked for and no CUDA device is "
            "available; pass device='cpu' to serve on the CPU")
    return dev


def build_stack(cfg, device="cuda"):
    """Build (model, voxel_gen, assigners, class_ids_per_task, test_cfg).

    The model is in eval mode on ``device`` (the card unless the caller
    asks for the CPU; "cuda" without a card raises; the train step puts it
    in training mode for its own run) with the modules' default initial
    weights; load a state dict
    (``utils/convert.py::from_jax``) or call
    ``models/builder.py::init_weights`` before serving. Readers, middles
    and necks run in the precision their config gives (fp32 or bf16); the
    voxelizer in the config's order ("appearance" when it sets none, as in
    the JAX package).
    """
    vg_cfg = cfg["voxel_generator"]
    # mean readers get the fused-mean voxelizer unless the config opts out
    reader_type = cfg["model"].get("reader", {}).get("type", "")
    fuse_mean = vg_cfg.get("fuse_mean",
                           reader_type == "VoxelFeatureExtractorV3")
    voxel_gen = VoxelGenerator(
        voxel_size=vg_cfg["voxel_size"],
        point_cloud_range=vg_cfg["range"],
        max_num_points=vg_cfg.get("max_points_in_voxel", 100),
        max_voxels=vg_cfg.get("max_voxel_num", 20000),
        order=vg_cfg.get("order", "appearance"),
        fuse_mean=bool(fuse_mean))
    grid = voxel_gen.grid_size

    # order="yxz" emits voxel rows in the sparse middle's rank order: the
    # backbone skips its res0 reorder
    model_cfg = cfg["model"]
    bb_cfg = model_cfg.get("backbone") or {}
    if (voxel_gen.order == "yxz"
            and "SpMiddle" in str(bb_cfg.get("type", ""))):
        model_cfg = dict(model_cfg, backbone=dict(bb_cfg, pre_ranked=True))

    model = build_detector(model_cfg, train_cfg=cfg.get("train_cfg"),
                           test_cfg=cfg.get("test_cfg"), grid_size=grid)
    model = model.to(_device(device)).eval()

    assigner_cfg = cfg["assigner"]
    box_coder = build_box_coder(assigner_cfg["box_coder"])
    tasks = cfg["tasks"]
    assigners = build_target_assigners(assigner_cfg["target_assigner"],
                                       box_coder, tasks)
    osf = int(assigner_cfg["out_size_factor"])
    fm = [1, grid[1] // osf, grid[0] // osf]
    for a in assigners:
        a.generate_anchors(fm)
        if a.anchor_area_threshold >= 0:
            a.prepare_anchors_mask(voxel_gen.voxel_size,
                                   voxel_gen.point_cloud_range, grid)

    # global 1-based class ids per task, numbered over the flattened
    # class_names list
    flat: List[str] = []
    for t in tasks:
        flat += list(t["class_names"])
    class_ids_per_task = [[flat.index(n) + 1 for n in t["class_names"]]
                          for t in tasks]
    return model, voxel_gen, assigners, class_ids_per_task, \
        cfg.get("test_cfg")


def init_state(cfg, model, total_steps: int,
               steps_per_epoch: int = 1) -> tuple:
    """(TrainState, lr_fn) for ``model`` (built by ``build_stack``, its
    weights loaded): the schedules of ``cfg["lr_config"]`` over
    ``total_steps`` (the mmcv policies' base lr from
    ``cfg["optimizer"]["VALUE"]["lr"]``) and the optimizer of
    ``cfg["optimizer"]``, clipping gradients at a global norm of 35, as
    the JAX package's init_state does (every shipped config's
    ``optimizer_config`` says 35)."""
    base_lr = cfg["optimizer"].get("VALUE", {}).get("lr")
    lr_fn, mom_fn = build_lr_schedule(cfg["lr_config"], total_steps,
                                      steps_per_epoch=steps_per_epoch,
                                      base_lr=base_lr)
    tx = build_optimizer(cfg["optimizer"], model, lr_fn, mom_fn)
    return TrainState(model, tx), lr_fn
