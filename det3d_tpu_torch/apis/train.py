"""Build the stack from a config, the host plans it serves from, and the
train state.

Port of det3d_tpu/apis/train.py: ``build_stack`` (the same
reference-schema config -- ``voxel_generator``, ``model``, ``assigner``,
``tasks``, ``test_cfg`` -- builds the voxelizer, the detector, the per-task
assigners and the class ids), ``host_plan_fn`` (the sparse middle's
rulebooks and the voxels, built on the host for each request batch) and
``init_state`` (the optimizer and schedules of ``optimizer`` and
``lr_config``, for parallel/train.py::make_train_step), and the entry points
over a dataset: ``inject_host_plan`` (the HostPlan pipeline stage for
sparse middles), ``train_detector`` (config -> dataset -> loader workers
-> runtime/trainer.py's epochs with hooks and checkpoints -> resume) and
``eval_detector`` (predict over a split -> the dataset's official
evaluation).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

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
from det3d_tpu_torch.parallel import dist_utils
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


def with_point_width(model_cfg, width: int):
    """``model_cfg`` with its first layers' input widths set to ``width``,
    the columns of a point in the data: the reader's
    ``num_input_features`` and, behind a mean reader
    (``VoxelFeatureExtractorV3``, whose rows are the points' means), the
    middle's.

    The JAX package's layers take these widths from the batch (flax infers
    a layer's input width at ``init``), whatever the config says: its
    nuScenes and Lyft examples carry 6 columns (pipelines/loading.py)
    where the shipped configs say 5, so its first layers take 6. The
    port's layers take theirs from the config; the entry points over a
    dataset set them from its first example (``example_width``)."""
    reader = dict(model_cfg.get("reader") or {}, num_input_features=width)
    out = dict(model_cfg, reader=reader)
    if (reader.get("type") == "VoxelFeatureExtractorV3"
            and model_cfg.get("backbone")):
        out["backbone"] = dict(model_cfg["backbone"],
                               num_input_features=width)
    return out


def example_width(split_cfg) -> int:
    """The columns of a point in a split's examples: its first example's
    ``points``, run through the split's pipeline on a dataset of its own.
    The loading and the augmentations draw from the global
    ``np.random``; its state is restored after, so that the draws of the
    run that follows do not move."""
    from det3d_tpu_torch.datasets import build_dataset
    saved = np.random.get_state()
    try:
        return int(build_dataset(split_cfg)[0]["points"].shape[-1])
    finally:
        np.random.set_state(saved)


def build_stack(cfg, device="cuda", point_width=None):
    """Build (model, voxel_gen, assigners, class_ids_per_task, test_cfg).

    The model is in eval mode on ``device`` (the card unless the caller
    asks for the CPU; "cuda" without a card raises; the train step puts it
    in training mode for its own run) with the modules' default initial
    weights; load a state dict
    (``utils/convert.py::from_jax``) or call
    ``models/builder.py::init_weights`` before serving. Readers, middles
    and necks run in the precision their config gives (fp32 or bf16); the
    voxelizer in the config's order ("appearance" when it sets none, as in
    the JAX package). ``point_width``: the columns of a point in the data
    the model will see (``with_point_width``); None keeps the config's
    widths.
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
    if point_width is not None:
        model_cfg = with_point_width(model_cfg, point_width)
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


# the batch keys the train and loss-eval steps read; the loader's other
# keys (metadata, the host plan's point_lin / point_perm, which the device
# voxelizer recomputes) stay on the host
TRAIN_KEYS = ("points", "num_points", "gt_boxes", "gt_classes", "gt_valid")
PREDICT_KEYS = ("points", "num_points")


def step_batch(batch: Dict[str, Any], keys=TRAIN_KEYS) -> Dict[str, Any]:
    """The arrays of a loader batch that a step takes: ``keys`` and a
    host plan's ``plan_*``."""
    return {k: v for k, v in batch.items()
            if k in keys or k.startswith("plan_")}


def inject_host_plan(cfg, model, voxel_gen, split: str = "train",
                     train: bool = True) -> bool:
    """Append the HostPlan pipeline stage to a split's pipeline when the
    model's sparse middle can consume host-built rulebooks.

    Loader workers then build every rulebook on the CPU
    (ops/sparse_host.py, the C++ of csrc/hostplan.cc) and the step builds
    none on the card. Opt out with ``host_plan = False`` in the config.
    Mutates cfg's pipeline in place; returns True when injected (or
    already present)."""
    if not cfg.get("host_plan", True):
        return False
    backbone = getattr(model, "backbone", None)
    if backbone is None or "SpMiddle" not in type(backbone).__name__:
        return False
    if voxel_gen.effective_order not in ("hashed", "yxz"):
        return False  # the appearance voxel ordering has no host twin
    pipeline = cfg["data"][split].get("pipeline")
    if not pipeline or any(
            (p.get("type") if isinstance(p, dict) else "") == "HostPlan"
            for p in pipeline):
        return bool(pipeline)
    spec = middle_plan_spec(backbone, voxel_gen.grid_size,
                            voxel_gen.max_voxels)
    pipeline.append(dict(
        type="HostPlan",
        voxel=dict(voxel_size=tuple(voxel_gen.voxel_size),
                   pc_range=tuple(voxel_gen.point_cloud_range),
                   grid_size=tuple(voxel_gen.grid_size),
                   max_voxels=int(voxel_gen.max_voxels),
                   order=voxel_gen.effective_order),
        spec=spec, train=train))
    logging.getLogger("det3d").info(
        "host rulebook plans: ON for %s (%d stages, order=%s) — loader "
        "workers build the sparse middle's rulebooks", split,
        len(spec["stages"]), voxel_gen.effective_order)
    return True


def train_detector(cfg, work_dir: Optional[str] = None,
                   resume_from: Optional[str] = None,
                   logger: Optional[logging.Logger] = None,
                   use_mesh: bool = True, seed: int = 0, device="cuda",
                   hooks=()):
    """Train a detector from a reference-schema config over its dataset
    (``cfg["data"]["train"]``); returns the ``Trainer``, whose ``state``
    holds the trained model.

    The stack is built on ``device`` (the card unless the caller asks
    for the CPU), its first layers as wide as the train split's points
    (``example_width``), with random weights from ``torch.Generator().
    manual_seed(seed)`` (models/builder.py::init_weights), before the
    loader forks its workers (seeded ``seed * 1000 + w``); sparse middles
    get the HostPlan stage. On the card the train step is captured at
    its first batch. ``work_dir`` holds the checkpoints (``ckpt/``), the
    logs and, unless ``tensorboard = False``, the tfevents file;
    ``resume_from`` (or ``cfg["resume_from"]``) is a work dir whose latest
    checkpoint is written into the state in place before the first step.
    A ``("val", n)`` workflow entry runs the validation loss over
    ``cfg["data"]["val"]``. ``hooks``: more runtime/hooks.py hooks (a
    profiler, a timer), registered after the standard ones at NORMAL.
    ``use_mesh`` is accepted for the JAX package's signature.

    Ranks: call it on every rank after ``parallel/dist_utils.py::
    initialize_distributed``. Each rank builds the stack on its own device
    (``rank_device``: under NCCL card ``rank % device_count``; ranks that
    share a card under gloo all use ``device``), with the seed's weights,
    then broadcasts rank 0's; its loader shards each epoch
    (DistributedGroupSampler) and takes ``samples_per_gpu`` a rank, so the
    global batch is ``samples_per_gpu`` x the world size (the reference's
    build_dataloader; ``scale_batch_by_devices = False`` pins the global
    batch to ``samples_per_gpu`` instead, which the world size must
    divide); the steps an epoch and the schedules' ``total_steps`` follow
    the sampler's length; the train step is the global step
    (parallel/train.py); rank 0 alone writes the logs and checkpoints.
    The JAX package counts ``n_dev = len(jax.devices())``, every
    process's devices, and hands each process's local batch to a step
    jitted over the global mesh, a path none of its tests runs; the port
    follows the tested semantics (tests/test_multiprocess.py), the global
    batch split over the ranks (ROADMAP queue 3)."""
    from det3d_tpu_torch.datasets import build_dataloader, build_dataset
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.parallel.train import (make_loss_eval_step,
                                                make_train_step)
    from det3d_tpu_torch.runtime.hooks import (CheckpointHook,
                                               IterTimerHook,
                                               TensorboardLoggerHook,
                                               TextLoggerHook)
    from det3d_tpu_torch.runtime.trainer import Trainer

    data_cfg = cfg["data"]
    _, world = dist_utils.get_dist_info()
    device = dist_utils.rank_device(device)
    model, voxel_gen, assigners, class_ids, _ = build_stack(
        cfg, device, point_width=example_width(data_cfg["train"]))
    init_weights(model, torch.Generator().manual_seed(seed))
    dist_utils.broadcast_tensors(list(model.parameters())
                                 + list(model.buffers()))

    inject_host_plan(cfg, model, voxel_gen)
    train_ds = build_dataset(data_cfg["train"])
    samples_per_gpu = data_cfg.get("samples_per_gpu", 2)
    # one rank's batch: samples_per_gpu (the reference's per-device batch;
    # the global batch is world times it), or with
    # scale_batch_by_devices=False a world-th of a global samples_per_gpu
    batch_size = samples_per_gpu
    if not cfg.get("scale_batch_by_devices", True):
        if samples_per_gpu % world:
            raise ValueError(f"train_detector: a global batch of "
                             f"{samples_per_gpu} over {world} ranks")
        batch_size = samples_per_gpu // world
    workers = data_cfg.get("workers_per_gpu", 0)
    loader = build_dataloader(train_ds, batch_size, workers_per_gpu=workers,
                              dist=world > 1, seed=seed)

    total_epochs = int(cfg.get("total_epochs", 20))
    total_steps = len(loader) * total_epochs
    state, lr_fn = init_state(cfg, model, total_steps,
                              steps_per_epoch=len(loader))
    train_step_raw = make_train_step(state, voxel_gen, assigners, class_ids)

    def train_step(batch):
        return train_step_raw(step_batch(batch))

    val_step = None
    workflow = list(cfg.get("workflow", [("train", 1)]))
    loaders = []
    for mode, _ in workflow:
        if mode == "train":
            loaders.append(loader)
            continue
        val_ds = build_dataset(data_cfg["val"])
        loaders.append(build_dataloader(val_ds, batch_size,
                                        workers_per_gpu=workers,
                                        shuffle=False, seed=seed))
        raw_val = make_loss_eval_step(model, voxel_gen, assigners, class_ids)

        def val_step(batch, _raw=raw_val):  # noqa: F811
            return _raw(step_batch(batch))

    trainer = Trainer(state, train_step, val_step, work_dir=work_dir,
                      lr_fn=lr_fn, logger=logger,
                      meta={"config": cfg.get("_text", ""),
                            "classes": [t["class_names"]
                                        for t in cfg["tasks"]]})
    trainer.register_hook(IterTimerHook())
    if work_dir:
        trainer.register_hook(CheckpointHook(
            interval=int(cfg.get("checkpoint_interval", 1))))
    log_interval = int(cfg.get("log_interval",
                               cfg.get("log_config", {}).get("interval", 10)))
    trainer.register_hook(TextLoggerHook(interval=log_interval), "VERY_LOW")
    if work_dir and cfg.get("tensorboard", True):
        trainer.register_hook(
            TensorboardLoggerHook(interval=log_interval), "VERY_LOW")
    for hook in hooks:
        trainer.register_hook(hook)
    if resume_from:
        trainer.resume(resume_from)
    elif cfg.get("resume_from"):
        trainer.resume(cfg["resume_from"])

    try:
        trainer.run(loaders, workflow, total_epochs)
    finally:
        for ld in loaders:
            ld.close()
    return trainer


def eval_detector(cfg, state, work_dir: Optional[str] = None,
                  split: str = "val", use_mesh: bool = True, device="cuda"):
    """Predict over a split and run the dataset's official evaluation;
    returns (results, detections by token).

    Parity: tools/dist_test.py:130-241 (minus the NCCL plumbing). The
    stack is built on ``device`` (the card unless the caller asks for the
    CPU), as wide as ``state.model``'s first layers (its reader's
    ``num_input_features``), and ``state.model``'s weights copied in;
    the predict step
    (captured on the card: one graph, the tail batch padded by repeating
    its last example) gives each batch's
    detections, read back once a batch. Sparse middles get the HostPlan
    stage (not under double-flip TTA, which flips the points in the
    step). Prints "Total time per frame" over the middle third of the
    batches, as the JAX package does. ``use_mesh`` is accepted for the
    JAX package's signature.

    Ranks: each rank predicts the strided shard ``range(len(ds))[rank::
    world]`` on its own device (``rank_device``), its tail batch padded
    as above, and the detections of every rank are gathered
    (``all_gather_objects``) in the split's order before the evaluation,
    which every rank runs on them all and returns; rank 0 alone writes
    its files into ``work_dir`` (det3d_tpu/apis/train.py:355-405)."""
    from det3d_tpu_torch.datasets import build_dataset
    from det3d_tpu_torch.datasets.loader.loader import collate
    from det3d_tpu_torch.parallel.predict import make_predict_step

    data_cfg = cfg["data"]
    rank, world = dist_utils.get_dist_info()
    device = dist_utils.rank_device(device)
    model, voxel_gen, assigners, class_ids, test_cfg = build_stack(
        cfg, device, point_width=state.model.reader.num_input_features)
    model.load_state_dict(state.model.state_dict())
    if not test_cfg.get("double_flip", False):
        inject_host_plan(cfg, model, voxel_gen, split=split, train=False)
    ds = build_dataset(data_cfg[split])
    batch_size = data_cfg.get("samples_per_gpu", 2)
    shard = list(range(len(ds)))[rank::world]
    order: Dict[str, int] = {}

    def batches():
        # fixed batch shape: pad the tail chunk by repeating its last
        # example (duplicate tokens just overwrite in the detections dict)
        for i in range(0, len(shard), batch_size):
            idx = shard[i:i + batch_size]
            examples = [ds[j] for j in idx]
            examples += examples[-1:] * (batch_size - len(examples))
            batch = collate(examples)
            for j, meta in zip(idx, batch["metadata"]):
                order[str(meta["token"])] = j
            yield batch

    predict_step = make_predict_step(model, voxel_gen, assigners, class_ids,
                                     test_cfg)
    detections: Dict[str, Any] = {}
    times = []
    for batch in batches():
        t0 = time.perf_counter()
        out = predict_step(step_batch(batch, PREDICT_KEYS))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        times.append(time.perf_counter() - t0)
        for b, meta in enumerate(batch["metadata"]):
            v = out["valid"][b]
            detections[str(meta["token"])] = {
                "box3d_lidar": out["box3d_lidar"][b][v],
                "scores": out["scores"][b][v],
                "label_preds": out["label_preds"][b][v],
                "metadata": meta,
            }
    if len(times) > 2:
        mid = times[len(times) // 3: 2 * len(times) // 3]
        per_frame = float(np.mean(mid)) / batch_size
        print(f"Total time per frame: {per_frame * 1e3:.1f} ms")
    if world > 1:
        merged, where = {}, {}
        for d, o in dist_utils.all_gather_objects((detections, order)):
            merged.update(d)
            where.update(o)
        detections = {k: merged[k] for k in sorted(merged, key=where.get)}
    results, _ = ds.evaluation(detections, work_dir if rank == 0 else None)
    return results, detections
