"""The one traffic generator: a mix's JSON parameters and the seed ->
the pool of host batches a run cycles through.

A mix (``benchmark/traffic/<name>.json``) names its ``mode`` ("serve":
one client's closed loop of requests of ``batch`` scans, the only
serving load core/serve.py runs; "train": train steps back to back on
batches of the configuration's ``samples_per_gpu`` unless ``batch`` says
otherwise) and its scans: ``cap_points`` a scan, ``valid_points``
[lo, hi] (the pool's counts are evenly spaced over it and shuffled),
``pool`` distinct scans (serve) or batches (train), the scene each mode
draws from (serve: scenes.structured_scan with ``n_objects``; train:
scenes.class_scene with ``gt``, ``total_steps`` and ``loss_every``),
and, for a configuration whose points have a fifth column, ``sweeps``
(count, step): the column is the sweep time, one of count steps from 0.
A key that no code reads is refused (``check``), so that a mix can never
ask for a load the harness does not run. The scans themselves come from
the mix's ``scan_seed``, so every seed serves the same set of scans (the
same work) in another order: ``--seed`` draws the order, and the weights.
Draws go through numpy's SeedSequence, so any whole number is a seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.core import scenes


KEYS = {"serve": {"n_objects"}, "train": {"gt", "total_steps", "loss_every"}}
COMMON = {"mode", "batch", "cap_points", "valid_points", "pool",
          "scan_seed", "sweeps"}


def check(mix):
    """Refuse a mix whose mode is unknown or that names a key the
    generator and the runners do not read."""
    mode = mix.get("mode")
    if mode not in KEYS:
        raise ValueError(f"traffic mode {mode!r}: not one of {sorted(KEYS)}")
    unread = sorted(set(mix) - COMMON - KEYS[mode])
    if unread:
        raise ValueError(f"traffic keys {unread} are read by nothing: a "
                         f"{mode} mix takes {sorted(COMMON | KEYS[mode])}")


def _seeds(seed: int, n: int) -> List[int]:
    ss = np.random.SeedSequence(int(seed))
    return [int(v) for v in ss.generate_state(n, np.uint32)]


def _counts(mix, n, rng) -> np.ndarray:
    lo, hi = (int(v) for v in mix["valid_points"])
    counts = np.linspace(lo, hi, n).round().astype(np.int32)
    return counts[rng.permutation(n)]


def _columns(cfg) -> int:
    return int(cfg["model"]["reader"].get("num_input_features", 4))


def _sweep_column(mix, n, rng):
    sw = mix.get("sweeps")
    if not sw:
        return np.zeros((n,), np.float32)
    return (rng.randint(0, int(sw["count"]), n) * float(sw["step"])
            ).astype(np.float32)


def _with_columns(pts4, cols, mix, rng):
    if cols == 4:
        return pts4
    extra = [_sweep_column(mix, pts4.shape[0], rng)[:, None]]
    extra += [np.zeros((pts4.shape[0], 1), np.float32)] * (cols - 5)
    return np.concatenate([pts4] + extra, 1)


def batch_size(mix, cfg) -> int:
    b = mix.get("batch", "config")
    return int(cfg["samples_per_gpu"]) if b == "config" else int(b)


def _order(seed, n) -> np.ndarray:
    """The seed's order of the pool's n scans."""
    return np.random.RandomState(_seeds(seed, 1)[0]).permutation(n)


def serve_pool(mix, cfg, seed) -> List[Dict[str, np.ndarray]]:
    """The distinct request batches: ``pool`` scans in the seed's order,
    ``batch`` a request, cycled in order."""
    check(mix)
    n = int(mix["pool"])
    b = batch_size(mix, cfg)
    if n % b:
        raise ValueError(f"serve pool of {n} scans in batches of {b}")
    s = _seeds(int(mix.get("scan_seed", seed)), n + 1)
    rng = np.random.RandomState(s[-1])
    counts = _counts(mix, n, rng)
    cap = int(mix["cap_points"])
    cols = _columns(cfg)
    pc = cfg["voxel_generator"]["range"]
    scans = np.zeros((n, cap, cols), np.float32)
    for i in range(n):
        pts = scenes.structured_scan(int(counts[i]), pc, n_objects=int(
            mix.get("n_objects", 12)), seed=s[i])
        scans[i, :counts[i]] = _with_columns(pts, cols, mix, rng)
    order = _order(seed, n)
    scans, counts = scans[order], counts[order]
    return [{"points": np.ascontiguousarray(scans[j:j + b]),
             "num_points": np.ascontiguousarray(counts[j:j + b])}
            for j in range(0, n, b)]


def _kinds(cfg, mix, n_gt, rng):
    """(class id, w, l, h, z) of n_gt boxes: classes drawn over the
    configuration's anchor generators (1-based, in their order), each
    with its anchor's size and height."""
    gens = cfg["assigner"]["target_assigner"]["anchor_generators"]
    out = []
    for _ in range(n_gt):
        c = int(rng.randint(0, len(gens)))
        w, l, h = (float(v) for v in gens[c]["sizes"])
        out.append((c + 1, w, l, h, float(gens[c]["anchor_ranges"][2])))
    return out


def train_pool(mix, cfg, seed) -> List[Dict[str, np.ndarray]]:
    """``pool`` train batches of scenes.class_scene scans with gt, the
    scans in the seed's order."""
    check(mix)
    n = int(mix["pool"])
    b = batch_size(mix, cfg)
    s = _seeds(int(mix.get("scan_seed", seed)), n * b + 1)
    rng = np.random.RandomState(s[-1])
    counts = _counts(mix, n * b, rng)
    lo, hi = (int(v) for v in mix["gt"]["per_scan"])
    n_gts = np.resize(np.arange(lo, hi + 1), n * b)[rng.permutation(n * b)]
    max_gt = int(mix["gt"]["max_gt"])
    cap = int(mix["cap_points"])
    cols = _columns(cfg)
    nd = int(cfg["model"]["bbox_head"]["box_coder"].get("n_dim", 7))
    pc = cfg["voxel_generator"]["range"]
    scenes_ = []                          # in the scan set's own order
    for k in range(n * b):
        p4, gt, gcls, gval = scenes.class_scene(
            int(counts[k]), pc, _kinds(cfg, mix, int(n_gts[k]), rng),
            max_gt, nd, s[k])
        scenes_.append((_with_columns(p4, cols, mix, rng), gt, gcls, gval))
    order = _order(seed, n * b)
    out = []
    for j in range(n):
        ks = [int(k) for k in order[j * b:(j + 1) * b]]
        pts = np.zeros((b, cap, cols), np.float32)
        for i, k in enumerate(ks):
            pts[i, :counts[k]] = scenes_[k][0]
        out.append({"points": pts,
                    "num_points": np.ascontiguousarray(counts[ks]),
                    "gt_boxes": np.stack([scenes_[k][1] for k in ks]),
                    "gt_classes": np.stack([scenes_[k][2] for k in ks]),
                    "gt_valid": np.stack([scenes_[k][3] for k in ks])})
    return out


def pool(mix, cfg, seed):
    return (serve_pool if mix["mode"] == "serve" else train_pool)(
        mix, cfg, seed)
