"""The synthetic mini-KITTI tree and its small configs.

The port's copy of the JAX package's tests/mini_kitti.py (its tree writer
and ``mini_config`` / ``mini_second_config``), on the port's box_np,
kitti_common and create_gt_database, so that chip_smoke.py and the port's
tests write the same tree without the JAX package:

    from det3d_tpu_torch.utils import mini_kitti as mk
    mk.make_tree(root, n_scenes=16)           # scenes, infos, gt database
    cfg = mk.mini_config(str(root), total_epochs=150, workers=2)

Scenes hold Car boxes on alternating slots in front of the sensor (200
points each, in the box) among 4000 clutter points; the first half of the
scenes is the train split, the second half val.
"""

from pathlib import Path

import numpy as np

from det3d_tpu_torch.core import box_np

# lidar (x fwd, y left, z up) -> camera (x right, y down, z fwd)
TR_VELO_TO_CAM = np.array([
    [0, -1, 0, 0],
    [0, 0, -1, 0],
    [1, 0, 0, 0],
    [0, 0, 0, 1.0]])
P2 = np.array([
    [500.0, 0, 621, 0],
    [0, 500.0, 187, 0],
    [0, 0, 1, 0],
    [0, 0, 0, 1.0]])
R0 = np.eye(4)

ALL_SLOTS = [(9, -6), (9, 0), (9, 6), (14, -5), (14, 2), (17, -2),
             (9, -3), (9, 3), (11, 7), (14, -2), (14, 5), (17, 2)]


def write_scene(root, idx, boxes_lidar, names, rng):
    """boxes_lidar: (N, 7) [x y z w l h yaw] true-center."""
    velo_dir = root / "training" / "velodyne"
    label_dir = root / "training" / "label_2"
    calib_dir = root / "training" / "calib"
    for d in (velo_dir, label_dir, calib_dir):
        d.mkdir(parents=True, exist_ok=True)

    pts = []
    for b in boxes_lidar:
        local = rng.uniform(-0.45, 0.45, (200, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        x = local[:, 0] * c + local[:, 1] * s + b[0]
        y = -local[:, 0] * s + local[:, 1] * c + b[1]
        z = local[:, 2] + b[2]
        pts.append(np.stack([x, y, z, rng.uniform(0, 1, 200)], -1))
    clutter = np.stack([
        rng.uniform(0, 60, 4000), rng.uniform(-20, 20, 4000),
        rng.uniform(-1.8, 0.5, 4000), rng.uniform(0, 1, 4000)], -1)
    points = np.concatenate(pts + [clutter]).astype(np.float32)
    points.tofile(velo_dir / f"{idx:06d}.bin")

    lines = []
    for b, name in zip(boxes_lidar, names):
        bottom = np.array([[b[0], b[1], b[2] - b[5] / 2]])
        loc_cam = box_np.lidar_to_camera(bottom, R0, TR_VELO_TO_CAM)[0]
        w, l, h = b[3], b[4], b[5]
        ry = b[6]
        corners = box_np.center_to_corner_box3d(
            loc_cam[None], np.array([[l, h, w]]), np.array([ry]),
            origin=[0.5, 1.0, 0.5], axis=1)
        img = box_np.project_to_image(corners, P2)[0]
        bbox = [img[:, 0].min(), img[:, 1].min(),
                img[:, 0].max(), img[:, 1].max()]
        lines.append(
            f"{name} 0.00 0 0.00 {bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} "
            f"{bbox[3]:.2f} {h:.2f} {w:.2f} {l:.2f} "
            f"{loc_cam[0]:.2f} {loc_cam[1]:.2f} {loc_cam[2]:.2f} {ry:.2f}")
    (label_dir / f"{idx:06d}.txt").write_text("\n".join(lines) + "\n")

    calib_lines = []
    for key, mat in (("P0", P2), ("P1", P2), ("P2", P2), ("P3", P2)):
        calib_lines.append(
            key + ": " + " ".join(str(v) for v in mat[:3].reshape(-1)))
    calib_lines.append(
        "R0_rect: " + " ".join(str(v) for v in R0[:3, :3].reshape(-1)))
    calib_lines.append("Tr_velo_to_cam: " + " ".join(
        str(v) for v in TR_VELO_TO_CAM[:3].reshape(-1)))
    calib_lines.append("Tr_imu_to_velo: " + " ".join(
        str(v) for v in np.eye(4)[:3].reshape(-1)))
    (calib_dir / f"{idx:06d}.txt").write_text("\n".join(calib_lines) + "\n")


def make_tree(root, n_scenes=16, seed=0):
    """Write scenes + ImageSets + infos + gt database. Returns gt dict."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    gt_per_scene = {}
    for idx in range(n_scenes):
        slots = ALL_SLOTS[idx % 2::2]
        boxes = np.zeros((len(slots), 7))
        for g, (sx, sy) in enumerate(slots):
            boxes[g, 0] = sx + rng.uniform(-0.8, 0.8)
            boxes[g, 1] = sy + rng.uniform(-0.8, 0.8)
        boxes[:, 2] = -1.0
        boxes[:, 3:6] = [1.7, 4.1, 1.6]
        boxes[:, 6] = rng.uniform(-np.pi / 4, np.pi / 4, len(slots))
        write_scene(root, idx, boxes, ["Car"] * len(slots), rng)
        gt_per_scene[idx] = boxes
    (root / "ImageSets").mkdir(exist_ok=True)
    half = n_scenes // 2
    (root / "ImageSets" / "train.txt").write_text(
        "".join(f"{i}\n" for i in range(half)))
    (root / "ImageSets" / "val.txt").write_text(
        "".join(f"{i}\n" for i in range(half, n_scenes)))

    from det3d_tpu_torch.datasets.kitti.kitti_common import (
        create_kitti_info_file)
    from det3d_tpu_torch.datasets.utils.create_gt_database import (
        create_groundtruth_database)
    create_kitti_info_file(str(root))
    create_groundtruth_database(
        "KittiDataset", str(root), str(root / "kitti_infos_train.pkl"))
    return gt_per_scene


def mini_config(data_root: str, total_epochs=2, samples_per_gpu=2,
                workers=0):
    """Small PointPillars config dict in the reference schema."""
    import itertools
    import os

    tasks = [dict(num_class=1, class_names=["Car"])]
    class_names = list(
        itertools.chain(*[t["class_names"] for t in tasks]))
    pc_range = [0, -20.0, -3, 40.0, 20.0, 1]
    voxel_size = [0.4, 0.4, 4.0]
    target_assigner = dict(
        type="iou",
        anchor_generators=[dict(
            type="anchor_generator_range", sizes=[1.7, 4.1, 1.6],
            anchor_ranges=[0, -20.0, -1.0, 40.0, 20.0, -1.0],
            rotations=[0, 1.57], matched_threshold=0.5,
            unmatched_threshold=0.35, class_name="Car")],
        sample_positive_fraction=-1, sample_size=512,
        region_similarity_calculator=dict(type="nearest_iou_similarity"),
        tasks=tasks)
    box_coder = dict(type="ground_box3d_coder", n_dim=7, linear_dim=False,
                     encode_angle_vector=False)
    model = dict(
        type="PointPillars",
        # bf16 like the parity configs — the learning gate validates the
        # adopted mixed-precision training recipe
        reader=dict(type="PillarFeatureNet", num_filters=[32],
                    precision="bf16",
                    voxel_size=voxel_size, pc_range=pc_range,
                    with_distance=False, num_input_features=4),
        backbone=dict(type="PointPillarsScatter", ds_factor=1,
                      num_input_features=32),
        neck=dict(type="RPN", precision="bf16",
                  layer_nums=[1, 1], ds_layer_strides=[1, 2],
                  ds_num_filters=[32, 64], us_layer_strides=[1, 2],
                  us_num_filters=[32, 32], num_input_features=32),
        bbox_head=dict(
            type="MultiGroupHead", mode="3d", in_channels=64, tasks=tasks,
            weights=[1], box_coder=box_coder,
            encode_background_as_zeros=True,
            loss_norm=dict(type="NormByNumPositives", pos_cls_weight=1.0,
                           neg_cls_weight=1.0),
            loss_cls=dict(type="SigmoidFocalLoss", alpha=0.25, gamma=2.0,
                          loss_weight=1.0),
            loss_bbox=dict(type="WeightedSmoothL1Loss", sigma=3.0,
                           codewise=True, loss_weight=2.0),
            encode_rad_error_by_sin=True,
            loss_aux=dict(type="WeightedSoftmaxClassificationLoss",
                          name="direction_classifier", loss_weight=0.2),
            direction_offset=0.0))
    train_preprocessor = dict(
        mode="train", shuffle_points=True,
        gt_loc_noise=[0.25, 0.25, 0.25], gt_rot_noise=[-0.15, 0.15],
        global_rot_noise=[-0.78, 0.78], global_scale_noise=[0.95, 1.05],
        global_trans_noise=[0.0, 0.0, 0.0], remove_unknown_examples=False,
        db_sampler=dict(
            type="GT-AUG", enable=True,
            db_info_path=os.path.join(data_root, "dbinfos_train.pkl"),
            sample_groups=[dict(Car=12)],
            db_prep_steps=[dict(filter_by_min_num_points=dict(Car=5)),
                           dict(filter_by_difficulty=[-1])],
            rate=1.0),
        class_names=class_names)
    train_pipeline = [
        dict(type="LoadPointCloudFromFile", dataset="KittiDataset"),
        dict(type="LoadPointCloudAnnotations", with_bbox=True),
        dict(type="Preprocess", cfg=train_preprocessor),
        dict(type="Reformat", max_points=8192, max_gt=32)]
    test_pipeline = [
        dict(type="LoadPointCloudFromFile", dataset="KittiDataset"),
        dict(type="LoadPointCloudAnnotations", with_bbox=True),
        dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
        dict(type="Reformat", max_points=8192, max_gt=32)]
    return dict(
        tasks=tasks,
        model=model,
        assigner=dict(box_coder=box_coder, target_assigner=target_assigner,
                      out_size_factor=1),
        test_cfg=dict(
            nms=dict(use_rotate_nms=True, use_multi_class_nms=False,
                     nms_pre_max_size=512, nms_post_max_size=48,
                     nms_iou_threshold=0.5),
            score_threshold=0.3,
            post_center_limit_range=[0, -25, -5, 45, 25, 5],
            max_per_img=48),
        voxel_generator=dict(range=pc_range, voxel_size=voxel_size,
                             max_points_in_voxel=20, max_voxel_num=4096),
        data=dict(
            samples_per_gpu=samples_per_gpu, workers_per_gpu=workers,
            train=dict(type="KittiDataset", root_path=data_root,
                       info_path=os.path.join(
                           data_root, "kitti_infos_train.pkl"),
                       class_names=class_names, pipeline=train_pipeline),
            val=dict(type="KittiDataset", root_path=data_root,
                     info_path=os.path.join(
                         data_root, "kitti_infos_val.pkl"),
                     class_names=class_names, pipeline=test_pipeline,
                     test_mode=True)),
        optimizer=dict(TYPE="adam", VALUE=dict(amsgrad=0.0, wd=0.01),
                       FIXED_WD=True),
        lr_config=dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85],
                       div_factor=10.0, pct_start=0.4),
        checkpoint_interval=1, log_interval=2,
        total_epochs=total_epochs, workflow=[("train", 1)],
        tensorboard=False,
    )


def mini_second_config(data_root: str, total_epochs=2, samples_per_gpu=2,
                       workers=0):
    """Small SECOND (VoxelNet + SpMiddleFHD sparse middle) config in the
    reference schema — the sparse-family twin of mini_config, mirroring
    examples/second/configs/kitti_car_vfev3_spmiddlefhd_rpn1_mghead_syncbn.py
    at mini scale (z grid of 40 so the 4 sparse stages reduce 41->2)."""
    cfg = mini_config(data_root, total_epochs=total_epochs,
                      samples_per_gpu=samples_per_gpu, workers=workers)
    pc_range = [0, -20.0, -3, 40.0, 20.0, 1]
    voxel_size = [0.2, 0.2, 0.1]
    cfg["voxel_generator"] = dict(range=pc_range, voxel_size=voxel_size,
                                  max_points_in_voxel=5, max_voxel_num=8000)
    head = cfg["model"]["bbox_head"]
    head = dict(head, in_channels=64)
    cfg["model"] = dict(
        type="VoxelNet",
        reader=dict(type="VoxelFeatureExtractorV3", num_input_features=4),
        backbone=dict(type="SpMiddleFHD", num_input_features=4, ds_factor=8),
        neck=dict(type="RPN", layer_nums=[2], ds_layer_strides=[1],
                  ds_num_filters=[64], us_layer_strides=[1],
                  us_num_filters=[64], num_input_features=128),
        bbox_head=head)
    cfg["assigner"] = dict(cfg["assigner"], out_size_factor=8)
    cfg["test_cfg"] = dict(cfg["test_cfg"])
    return cfg
