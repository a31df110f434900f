"""Host-side voxelization, the serving path's data plane.

Port of det3d_tpu/ops/voxelize_host.py: the sorted voxel orders
("hashed", "yxz"), the fused-mean path, and the "appearance" (first-come)
order of the buffer path. The serving process voxelizes on the CPU,
beside the rulebook plan (ops/sparse_host.py), and the device step takes
the voxels as they are (parallel/predict.py's build_example passthrough).
Every output equals the device voxelizer's (core/voxelize.py) array for
array.

``host_voxelize`` and ``host_voxelize_batch`` run the C++ twins of
csrc/hostplan.cc (``hp_voxelize_sorted``, ``hp_voxelize_appearance``,
``hp_argsort_lin``), built with g++ at first use; a failed build raises.
``host_voxelize_ref`` is the same function in numpy, the plain version
that the tests and chip_smoke.py hold them to.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from det3d_tpu_torch.ops import sparse_host as sph

SENTINEL = np.iinfo(np.int32).max


def _effective_order(order, fuse_mean):
    # the fused-mean path always sorts by a fast key
    return ("yxz" if fuse_mean and order == "yxz" else
            "hashed" if fuse_mean else order)


def host_voxelize(points, num_points, *, voxel_size, pc_range, grid_size,
                  max_voxels, max_points, order, fuse_mean,
                  lin=None, perm=None) -> Dict[str, np.ndarray]:
    """Voxelize one cloud.

    Returns voxels ((V, T, C) buffer, or (V, C) means when fuse_mean),
    coords (V, 3) int32 zyx, -1 padded, num_points_per_voxel (V,) int32
    and num_voxels () int32. The fused-mean path always sorts by a fast
    key: "yxz" when ``order`` is "yxz", else "hashed".

    ``lin``/``perm``: voxel ids and sort order that a plan builder already
    computed (they must match the effective order); passing both skips the
    quantize and sort.
    """
    eff = _effective_order(order, fuse_mean)
    pts = np.ascontiguousarray(points, np.float32)
    if lin is None or perm is None:
        lin = sph.point_lin(pts, int(num_points), voxel_size, pc_range,
                            grid_size)
        perm = (sph.argsort_lin(lin) if eff == "appearance"
                else sph.point_order(lin, grid_size, eff))
    lin, perm = sph._lin(lin), sph._i32(perm)
    P, C = pts.shape
    if lin.shape[0] != P or perm.shape[0] != P:
        raise ValueError(f"lin {lin.shape} and perm {perm.shape} must have "
                         f"the cloud's {P} rows")
    gx, gy, _ = grid_size
    V, T = int(max_voxels), int(max_points)
    voxels = np.empty((V, C) if fuse_mean else (V, T, C), np.float32)
    coords = np.empty((V, 3), np.int32)
    counts = np.empty(V, np.int32)
    if eff == "appearance":
        nv = sph._lib().hp_voxelize_appearance(pts, P, C, lin, perm, gx, gy,
                                               V, T, voxels, coords, counts)
    else:
        nv = sph._lib().hp_voxelize_sorted(pts, P, C, lin, perm, gx, gy, V,
                                           T, int(fuse_mean), voxels,
                                           coords, counts)
    return {"voxels": voxels, "coords": coords,
            "num_points_per_voxel": counts, "num_voxels": np.int32(nv)}


def host_voxelize_ref(points, num_points, *, voxel_size, pc_range,
                      grid_size, max_voxels, max_points, order, fuse_mean,
                      lin=None, perm=None) -> Dict[str, np.ndarray]:
    """``host_voxelize`` in numpy: the same outputs, array for array."""
    eff = _effective_order(order, fuse_mean)
    pts = np.asarray(points, np.float32)
    if lin is None or perm is None:
        lin = sph.point_lin_ref(pts, int(num_points), voxel_size, pc_range,
                                grid_size)
        perm = (np.argsort(lin, kind="stable") if eff == "appearance"
                else sph.point_order_ref(lin, grid_size, eff))
    P, C = pts.shape
    gx, gy, _ = grid_size
    V, T = int(max_voxels), int(max_points)
    if eff == "appearance":
        return _appearance(pts, lin, perm, gx, gy, V, T)

    pos = np.arange(P, dtype=np.int64)
    slin = lin[perm].astype(np.int64)
    svalid = slin != SENTINEL
    head = svalid.copy()
    head[1:] &= slin[1:] != slin[:-1]
    seg_id = np.maximum(np.cumsum(head) - 1, 0)
    start = np.maximum.accumulate(np.where(head, pos, 0))
    slot_p = pos - start
    write = svalid & (seg_id < V) & (slot_p < T)

    # head rows carry (z, y, x, start_pos)
    safe = np.where(svalid, slin, 0)
    zz, yy, xx = safe // (gx * gy), (safe // gx) % gy, safe % gx
    n_heads = int(head.sum())
    num_voxels = np.int32(min(n_heads, V))
    vvalid = np.arange(V) < num_voxels
    table = np.zeros((V, 4), np.int32)
    hw = head & (seg_id < V)
    table[seg_id[hw]] = np.stack([zz, yy, xx, pos], 1)[hw]
    coords = np.where(vvalid[:, None], table[:, :3], -1).astype(np.int32)

    n_kept = int((svalid & (seg_id < V)).sum())
    starts = np.where(vvalid, table[:, 3], n_kept)
    ends = np.concatenate([starts[1:], [n_kept]])
    counts = np.clip(ends - starts, 0, T)
    counts = np.where(vvalid, counts, 0).astype(np.int32)

    if fuse_mean:
        contrib = pts[perm] * write[:, None].astype(np.float32)
        sums = np.zeros((V, C), np.float32)
        # accumulate in sorted-row order, as the JAX device scatter-add
        np.add.at(sums, seg_id[write], contrib[write])
        means = sums / np.maximum(counts, 1)[:, None].astype(np.float32)
        return {"voxels": means, "coords": coords,
                "num_points_per_voxel": counts, "num_voxels": num_voxels}

    voxels = np.zeros((V, T, C), np.float32)
    voxels[seg_id[write], slot_p[write]] = pts[perm][write]
    return {"voxels": voxels, "coords": coords,
            "num_points_per_voxel": counts, "num_voxels": num_voxels}


def _appearance(pts, lin, perm, gx, gy, V, T):
    """The appearance-ordered buffer path of one cloud, ``perm`` a stable
    argsort of ``lin``: voxel rows in first-come order, ranked by each
    segment's first point, which the stable sort puts at its head."""
    P, C = pts.shape
    pos = np.arange(P, dtype=np.int64)
    slin = lin[perm].astype(np.int64)
    svalid = slin != SENTINEL
    head = svalid.copy()
    head[1:] &= slin[1:] != slin[:-1]
    seg_id = np.maximum(np.cumsum(head) - 1, 0)
    start = np.maximum.accumulate(np.where(head, pos, 0))
    slot_p = pos - start

    first_pt = np.full(P, SENTINEL, np.int64)
    first_pt[seg_id[head]] = perm[head]
    seg_rank = np.empty(P, np.int64)
    seg_rank[np.argsort(first_pt, kind="stable")] = pos
    slot_v = seg_rank[seg_id]
    write = svalid & (slot_v < V) & (slot_p < T)

    voxels = np.zeros((V, T, C), np.float32)
    voxels[slot_v[write], slot_p[write]] = pts[perm][write]
    counts = np.bincount(slot_v[write], minlength=V).astype(np.int32)

    safe = np.where(svalid, slin, 0)
    hw = head & (slot_v < V)
    coords = np.full((V, 3), -1, np.int32)
    coords[slot_v[hw]] = np.stack([safe // (gx * gy), (safe // gx) % gy,
                                   safe % gx], 1)[hw]
    num_voxels = np.int32(min(int(head.sum()), V))
    return {"voxels": voxels, "coords": coords,
            "num_points_per_voxel": counts, "num_voxels": num_voxels}


def stack_voxels(per) -> Dict[str, np.ndarray]:
    """Per-sample host_voxelize dicts -> the batch's example keys."""
    return {"voxels": np.stack([d["voxels"] for d in per]),
            "coordinates": np.stack([d["coords"] for d in per]),
            "num_points_per_voxel": np.stack(
                [d["num_points_per_voxel"] for d in per]),
            "num_voxels": np.stack([d["num_voxels"] for d in per])}


def host_voxelize_batch(points, num_points, voxel_gen) \
        -> Dict[str, np.ndarray]:
    """Voxelize a (B, P, C) batch as ``voxel_gen`` (core/voxelize.py's
    VoxelGenerator) would; returns the batch-stacked example keys."""
    points = np.asarray(points)
    num_points = np.asarray(num_points)
    return stack_voxels([
        host_voxelize(points[i], num_points[i], **voxel_gen.host_kwargs())
        for i in range(points.shape[0])])
