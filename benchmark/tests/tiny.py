"""A tiny copy of the benchmark's cells for the CPU tests: the shipped
configurations cut to a few metres and a few hundred voxels, the mixes to
a few thousand points, written as data into a directory of its own.

Everything is found through a manifest (``BENCHMARK.json`` at a root,
this checkout's by default): a configuration by its entry's ``file``, a
mix by the cells that run it, so that a configuration, mix or cell added
as files and entries is cut and tested with no edit here."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Dict, List, Tuple

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# the first two configurations' cuts: (half-width in metres, voxel cap,
# "x": 0 to twice the half-width ahead, "xy": both axes centred)
CUTS = {"second-kitti-car": (3.2, 600, "x"), "cbgs-nusc": (3.2, 500, "xy")}
DEFAULT_CUT = (3.2, 500)
# mixes no cell runs, with the configuration their tests cut for them
UNUSED_MIXES = {"train-points-300k-sweeps": "cbgs-nusc"}


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_file(name: str, root: Path = ROOT) -> Path:
    """A configuration's file, as its manifest entry names it."""
    for c in manifest(root)["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration {name!r} in {root / 'BENCHMARK.json'}")


def cut_of(name: str, cfg: dict) -> Tuple[float, int, str]:
    """(half-width, voxel cap, kind) of a configuration's cut: CUTS' for
    the configurations it names; any other's from its own range: one that
    starts at x >= 0 (KITTI-like, the scene ahead) to 0-6.4 m ahead, any
    other to +-3.2 m, and its voxel cap to 500 at most."""
    if name in CUTS:
        return CUTS[name]
    e, cap = DEFAULT_CUT
    vg = cfg["voxel_generator"]
    kind = "x" if vg["range"][0] >= 0 else "xy"
    return e, min(cap, int(vg.get("max_voxel_num", cap))), kind


def tiny_config(name: str, root: Path = ROOT) -> dict:
    """The configuration cut to +-3.2 m (KITTI: 0-6.4 m ahead) and a small
    voxel cap; every width as published."""
    cfg = copy.deepcopy(json.loads(config_file(name, root).read_text()))
    e, voxels, kind = cut_of(name, cfg)
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


def mix_of(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def tiny_mix(name: str, root: Path = ROOT) -> dict:
    mix = mix_of(name, root)
    mix.update(cap_points=3000, valid_points=[2000, 3000])
    if mix["mode"] == "serve":
        mix.update(pool=4, n_objects=2)
    else:
        mix.update(pool=3, gt={"per_scan": [2, 4], "max_gt": 6})
    return mix


def pairs(root: Path = ROOT) -> List[Tuple[str, str, str]]:
    """(configuration, mix, mode) of each cell of the manifest, in its
    order, each pair once, then each mix of UNUSED_MIXES that no cell
    runs, with its configuration."""
    out: List[Tuple[str, str, str]] = []
    for w in manifest(root)["workloads"]:
        p = (w["config"], w["traffic"])
        if p not in [o[:2] for o in out]:
            out.append(p + (mix_of(w["traffic"], root)["mode"],))
    used = {o[1] for o in out}
    for mix, conf in UNUSED_MIXES.items():
        if mix not in used:
            out.append((conf, mix, mix_of(mix, root)["mode"]))
    return out


def mixes(root: Path = ROOT) -> Dict[str, str]:
    """{mix: the configuration of its first pair}, in pairs' order."""
    out: Dict[str, str] = {}
    for conf, mix, _ in pairs(root):
        out.setdefault(mix, conf)
    return out


def write_tree(dest: Path, limits=None, source: Path = ROOT) -> Path:
    """``dest`` as a checkout root: BENCHMARK.json with one tiny cell per
    cell of ``source``'s manifest (the same names with a ``tiny-``
    prefix), and its metrics copied; returns dest."""
    m = manifest(source)
    sbench = source / "benchmark"
    (dest / "benchmark").mkdir(parents=True, exist_ok=True)
    shutil.copytree(sbench / "metrics", dest / "benchmark" / "metrics",
                    dirs_exist_ok=True)
    for sub in ("configs", "traffic", "limits"):
        (dest / "benchmark" / sub).mkdir(exist_ok=True)
    confs = []
    for c in m["configs"]:
        name = c["name"]
        c = dict(c, name=f"tiny-{name}",
                 file=f"benchmark/configs/tiny-{name}.json")
        (dest / c["file"]).write_text(json.dumps(tiny_config(name, source)))
        confs.append(c)
    cells = []
    for w in m["workloads"]:
        t = f"tiny-{w['traffic']}"
        (dest / "benchmark" / "traffic" / f"{t}.json").write_text(
            json.dumps(tiny_mix(w["traffic"], source)))
        name = f"tiny-{w['name']}"
        cells.append(dict(w, name=name, config=f"tiny-{w['config']}",
                          traffic=t))
        # at this size on the CPU sound runs read loss gaps to 3.5e-3
        # (steps 2 and 3: Adam's first step moves every element by lr
        # times the sign of its gradient, also where that sign is
        # rounding), gradient gaps to 1.5e-2, update gaps to 8.4e-2
        serve = mix_of(w["traffic"], source)["mode"] == "serve"
        lim = (limits or {}).get(w["name"], (
            {"head_gap": 1e-3, "nms_mismatch": 0.0, "unchecked": 0.0}
            if serve else
            {"loss_gap": 2e-2, "grad_gap": 6e-2, "update_gap": 0.3}))
        (dest / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in lim.items()}))
    for key in ("end_to_end", "per_layer"):
        for e in m[key]:
            if "workloads" in e:
                e["workloads"] = [f"tiny-{n}" for n in e["workloads"]]
    m.update(configs=confs, workloads=cells)
    (dest / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return dest
