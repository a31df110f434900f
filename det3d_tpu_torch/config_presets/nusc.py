"""Shared nuScenes config pieces (task split, per-class anchor table).

The port's copy of det3d_tpu/config_presets/nusc.py, which mirrors the
reference CBGS config
(examples/cbgs/configs/nusc_all_vfev3_spmiddleresnetfhd_rpn2_mghead_syncbn.py
:9-129). A config file's ``det3d_tpu.config_presets.*`` imports resolve to
this package when the port loads it (utils/config.py).
"""


def nusc_tasks():
    return [
        dict(num_class=1, class_names=["car"]),
        dict(num_class=2, class_names=["truck", "construction_vehicle"]),
        dict(num_class=2, class_names=["bus", "trailer"]),
        dict(num_class=1, class_names=["barrier"]),
        dict(num_class=2, class_names=["motorcycle", "bicycle"]),
        dict(num_class=2, class_names=["pedestrian", "traffic_cone"]),
    ]


_ANCHORS = [
    # (class, size wlh, z, match, unmatch)
    ("car", [1.97, 4.63, 1.74], -0.95, 0.6, 0.45),
    ("truck", [2.51, 6.93, 2.84], -0.40, 0.55, 0.4),
    ("construction_vehicle", [2.85, 6.37, 3.19], -0.225, 0.5, 0.35),
    ("bus", [2.94, 10.5, 3.47], -0.085, 0.55, 0.4),
    ("trailer", [2.90, 12.29, 3.87], 0.115, 0.5, 0.35),
    ("barrier", [2.53, 0.50, 0.98], -1.33, 0.55, 0.4),
    ("motorcycle", [0.77, 2.11, 1.47], -1.085, 0.5, 0.3),
    ("bicycle", [0.60, 1.70, 1.28], -1.18, 0.5, 0.35),
    ("pedestrian", [0.67, 0.73, 1.77], -0.935, 0.6, 0.4),
    ("traffic_cone", [0.41, 0.41, 1.07], -1.285, 0.6, 0.4),
]


def nusc_anchor_generators(extent=51.2):
    gens = []
    for name, size, z, m, u in _ANCHORS:
        gens.append(dict(
            type="anchor_generator_range", sizes=size,
            anchor_ranges=[-extent, -extent, z, extent, extent, z],
            rotations=[0, 1.57], velocities=[0, 0],
            matched_threshold=m, unmatched_threshold=u, class_name=name))
    return gens


def nusc_db_sampler(db_info_path, enable=False):
    return dict(
        type="GT-AUG", enable=enable, db_info_path=db_info_path,
        sample_groups=[
            dict(car=2), dict(truck=3), dict(construction_vehicle=7),
            dict(bus=4), dict(trailer=6), dict(barrier=2),
            dict(motorcycle=6), dict(bicycle=6), dict(pedestrian=2),
            dict(traffic_cone=2)],
        db_prep_steps=[
            dict(filter_by_min_num_points={
                n: 5 for n, *_ in _ANCHORS}),
            dict(filter_by_difficulty=[-1])],
        rate=1.0)
