"""The flagship serving configuration as a reference-schema config dict.

PointPillars at KITTI-car scale (reference config
examples/point_pillars/configs/kitti_point_pillars_mghead_syncbn.py), the
same stack that ``__graft_entry__._build_flagship`` builds for the JAX
package and ``bench.py::bench_flagship`` serves: hashed voxel order, full
widths, fp32, and bench_flagship's ``test_cfg``. ``small=True`` is the
narrow test variant of ``_build_flagship``. Feed the dict to
``apis/train.py::build_stack``.
"""

from __future__ import annotations

import copy

import numpy as np

PC_RANGE = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
VOXEL_SIZE = (0.16, 0.16, 4.0)

TEST_CFG = dict(
    nms=dict(use_rotate_nms=True, use_multi_class_nms=False,
             nms_pre_max_size=1000, nms_post_max_size=300,
             nms_iou_threshold=0.5),
    score_threshold=0.05,
    post_center_limit_range=[0, -40.0, -5.0, 70.4, 40.0, 5.0],
    max_per_img=100,
)


def flagship_config(voxel_size=VOXEL_SIZE, pc_range=PC_RANGE, max_points=32,
                    max_voxels=12000, small=False, precision="fp32"):
    """Config dict of the flagship PointPillars stack."""
    if small:
        neck = dict(type="RPN", layer_nums=[1, 1], ds_layer_strides=[1, 2],
                    ds_num_filters=[32, 64], us_layer_strides=[1, 2],
                    us_num_filters=[32, 32], num_input_features=32)
        reader_filters, head_in, out_size_factor = [32], 64, 1
        z_center = pc_range[2] + 2.0
    else:
        neck = dict(type="RPN", layer_nums=[3, 5, 5],
                    ds_layer_strides=[2, 2, 2],
                    ds_num_filters=[64, 128, 256],
                    us_layer_strides=[1, 2, 4],
                    us_num_filters=[128, 128, 128], num_input_features=64)
        reader_filters, head_in, out_size_factor = [64], 384, 2
        z_center = -1.0
    tasks = [dict(num_class=1, class_names=["Car"])]
    box_coder = dict(type="ground_box3d_coder", n_dim=7, linear_dim=False,
                     encode_angle_vector=False)
    model = dict(
        type="PointPillars",
        reader=dict(type="PillarFeatureNet", num_filters=reader_filters,
                    voxel_size=list(voxel_size), pc_range=list(pc_range),
                    with_distance=False, num_input_features=4,
                    precision=precision),
        backbone=dict(type="PointPillarsScatter",
                      num_input_features=reader_filters[-1]),
        neck=dict(neck, precision=precision),
        bbox_head=dict(
            type="MultiGroupHead", mode="3d", in_channels=head_in,
            tasks=tasks, weights=[1], box_coder=box_coder,
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
            direction_offset=0.0),
    )
    target_assigner = dict(
        anchor_generators=[dict(
            type="anchor_generator_range", sizes=[1.6, 3.9, 1.56],
            anchor_ranges=[pc_range[0], pc_range[1], z_center,
                           pc_range[3], pc_range[4], z_center],
            rotations=[0, np.pi / 2], matched_threshold=0.6,
            unmatched_threshold=0.45, class_name="Car")],
        sample_positive_fraction=-1, sample_size=512,
        region_similarity_calculator=dict(type="nearest_iou_similarity"))
    return dict(
        tasks=tasks,
        model=model,
        assigner=dict(box_coder=box_coder, target_assigner=target_assigner,
                      out_size_factor=out_size_factor),
        test_cfg=copy.deepcopy(TEST_CFG),
        voxel_generator=dict(range=list(pc_range),
                             voxel_size=list(voxel_size),
                             max_points_in_voxel=max_points,
                             max_voxel_num=max_voxels, order="hashed"),
    )
