"""Host-side (numpy) voxelization, the serving path's data plane.

Port of det3d_tpu/ops/voxelize_host.py for the sorted voxel orders
("hashed", "yxz") and the fused-mean path, in numpy. The serving process
voxelizes on the CPU, beside the rulebook plan (ops/sparse_host.py), and
the device step takes the voxels as they are (parallel/predict.py's
build_example passthrough). The "appearance" order without the fused
mean (with it, rows come in hashed order) and the JAX package's native
C++ twin are not ported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from det3d_tpu_torch.ops import sparse_host as sph

SENTINEL = np.iinfo(np.int32).max


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
    eff = ("yxz" if fuse_mean and order == "yxz" else
           "hashed" if fuse_mean else order)
    if eff not in ("hashed", "yxz"):
        raise NotImplementedError(f"host voxelization in order {order!r} "
                                  "is not ported yet")
    pts = np.asarray(points, np.float32)
    if lin is None or perm is None:
        lin = sph.point_lin(pts, int(num_points), voxel_size, pc_range,
                            grid_size)
        perm = sph.point_order(lin, grid_size, eff)
    P, C = pts.shape
    gx, gy, _ = grid_size
    V, T = int(max_voxels), int(max_points)

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
