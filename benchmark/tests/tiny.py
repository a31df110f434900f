"""A tiny copy of the benchmark's cells for the CPU tests: the shipped
configurations cut to a few metres and a few hundred voxels, the mixes to
a few thousand points, written as data into a directory of its own."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CUTS = {"second-kitti-car": (3.2, 600, "x"), "cbgs-nusc": (3.2, 500, "xy")}


def tiny_config(name: str) -> dict:
    """The configuration cut to +-3.2 m (KITTI: 0-6.4 m ahead) and a small
    voxel cap; every width as published."""
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{name}.json")
                                   .read_text()))
    e, voxels, kind = CUTS[name]
    rng = cfg["voxel_generator"]["range"]
    x0 = 0.0 if kind == "x" else -e
    x1 = 2 * e if kind == "x" else e
    cfg["voxel_generator"].update(range=[x0, -e, rng[2], x1, e, rng[5]],
                                  max_voxel_num=voxels)
    for g in cfg["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [x0, -e, z, x1, e, z]
    cfg["test_cfg"]["post_center_limit_range"] = [x0 - 1, -e - 1, -10.0,
                                                  x1 + 1, e + 1, 10.0]
    cfg["samples_per_gpu"] = 2
    cfg["name"] = f"tiny-{name}"
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    mix.update(cap_points=3000, valid_points=[2000, 3000])
    if mix["mode"] == "serve":
        mix.update(pool=4, n_objects=2)
    else:
        mix.update(pool=3, gt={"per_scan": [2, 4], "max_gt": 6})
    return mix


def write_tree(dest: Path, limits=None) -> Path:
    """``dest`` as a checkout root: BENCHMARK.json with one tiny cell per
    shipped cell (the same names with a ``tiny-`` prefix), and the
    benchmark's metrics copied; returns dest."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "benchmark").mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", dest / "benchmark" / "metrics",
                    dirs_exist_ok=True)
    for sub in ("configs", "traffic", "limits"):
        (dest / "benchmark" / sub).mkdir(exist_ok=True)
    confs = []
    for c in manifest["configs"]:
        c = dict(c, name=f"tiny-{c['name']}",
                 file=f"benchmark/configs/tiny-{c['name']}.json")
        (dest / c["file"]).write_text(json.dumps(tiny_config(
            c["name"][5:])))
        confs.append(c)
    cells = []
    for w in manifest["workloads"]:
        t = f"tiny-{w['traffic']}"
        (dest / "benchmark" / "traffic" / f"{t}.json").write_text(
            json.dumps(tiny_mix(w["traffic"])))
        name = f"tiny-{w['name']}"
        cells.append(dict(w, name=name, config=f"tiny-{w['config']}",
                          traffic=t))
        # at this size on the CPU sound runs read loss gaps to 3.5e-3
        # (steps 2 and 3: Adam's first step moves every element by lr
        # times the sign of its gradient, also where that sign is
        # rounding), gradient gaps to 1.5e-2, update gaps to 8.4e-2
        serve = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text())["mode"] == "serve"
        lim = (limits or {}).get(w["name"], (
            {"head_gap": 1e-3, "nms_mismatch": 0.0, "unchecked": 0.0}
            if serve else
            {"loss_gap": 2e-2, "grad_gap": 6e-2, "update_gap": 0.3}))
        (dest / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in lim.items()}))
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            if "workloads" in m:
                m["workloads"] = [f"tiny-{n}" for n in m["workloads"]]
    manifest.update(configs=confs, workloads=cells)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest
