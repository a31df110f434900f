"""Fixed-shape batched voxelization in torch: hashed, yxz and appearance
voxel orders, and the fused voxel mean.

Port of det3d_tpu/core/voxelize.py (``VoxelGenerator``'s buffer path,
``voxelize``): quantize points to linear voxel ids, stable-sort them so
each voxel's points are contiguous and keep their original order, find
segment heads, and scatter points into a (max_voxels, max_points, C)
buffer, dropping overflow. The reference vmaps one cloud at a time; here
the batch dimension is written out.

- ``order="hashed"`` sorts by (mix32(id), id): voxel rows in hash order,
  and an overflow keeps a uniform pseudo-random subset of the voxels.
- ``order="yxz"`` sorts by ((y * gx + x) * gz + z, id): voxel rows in
  the sparse middles' rank order (their ``pre_ranked``), and an overflow
  keeps a (y, x) scan-line prefix.
- ``order="appearance"`` (the JAX package's default) sorts by id and
  ranks the voxels by their first point: rows in first-come order, and an
  overflow keeps the voxels that appear first, as the reference's numba
  voxelizer does.

``fuse_mean=True`` (the mean readers of SECOND and CBGS) emits each
voxel's feature mean, (B, V, C), in the hashed or yxz order;
"appearance" then voxelizes in hashed order, as in the JAX package. The
host twins are ops/voxelize_host.py's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)
_U32 = 0xFFFFFFFF


def filled(values, like):
    """``values`` as a 1-D tensor of ``like``'s dtype on its device, each
    element written by a fill kernel. Unlike ``torch.tensor(values,
    device=...)``, which copies from pageable host memory and waits for
    the copy, this neither reads host memory nor waits, so a CUDA graph
    can capture it."""
    out = torch.empty(len(values), dtype=like.dtype, device=like.device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def quantize(points, num_points, voxel_size, pc_range, grid_size):
    """(B, P, C) points -> (B, P) int64 xyz-major linear voxel ids; padding
    and out-of-range points get SENTINEL. Port of voxelize.py::_quantize."""
    b, p = points.shape[:2]
    gx, gy, gz = grid_size
    vsize = filled(voxel_size, points)
    vmin = filled(pc_range[:3], points)
    valid = (torch.arange(p, device=points.device)[None, :]
             < num_points.to(points.device)[:, None])
    coords = torch.floor((points[..., :3] - vmin) / vsize).to(torch.int32)
    coords = coords.to(torch.int64)
    in_range = (
        valid
        & (coords[..., 0] >= 0) & (coords[..., 0] < gx)
        & (coords[..., 1] >= 0) & (coords[..., 1] < gy)
        & (coords[..., 2] >= 0) & (coords[..., 2] < gz))
    lin = coords[..., 0] + coords[..., 1] * gx + coords[..., 2] * (gx * gy)
    return torch.where(in_range, lin, SENTINEL)


def mix32(x):
    """Murmur3 finalizer, a bijection on uint32, computed in int64 with the
    product masked back to 32 bits. Port of voxelize.py::_mix32."""
    x = x & _U32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    x = x ^ (x >> 16)
    return x


def row_cumsum(x):
    """Inclusive cumsum of a (B, N) tensor along dim 1, as one scan of the
    flattened tensor less the totals of the earlier rows. torch scans a
    long last dim of few rows slowly and a single row with a device-wide
    scan: SECOND's device plan (bitmap rows of 2.25M columns) took 11.2 ms
    with row scans and 5.4 ms so (H100 80GB HBM3, chip_smoke.py
    --build-timing)."""
    c = x.reshape(-1).cumsum(0).view(x.shape)
    if x.shape[1] == 0:
        return c
    before = torch.cat([c.new_zeros(1), c[:-1, -1]])
    return c - before[:, None]


def scatter_rows(values, index, keep, n_rows: int):
    """Scatter (..., D) rows of ``values`` to rows ``index`` of a zeroed
    (n_rows, D) table, dropping rows where ``keep`` is False (the
    reference's out-of-bounds sentinel with ``mode="drop"``). Dropped rows
    go to one spare row past the end, which is cut off, so no index is out
    of bounds and the host never waits for a mask count. Kept indices must
    be unique."""
    d = values.shape[-1]
    out = torch.zeros((n_rows + 1, d), dtype=values.dtype,
                      device=values.device)
    idx = torch.where(keep, index, n_rows).reshape(-1)
    out[idx] = values.reshape(-1, d)
    return out[:n_rows]


def sort_key(lin, grid_size, key_mode: str):
    """The voxel sort key of the sorted orders. "hashed": mix32 of the id,
    so an overflow drops a uniform pseudo-random voxel subset. "yxz": the
    rank key (y * gx + x) * gz + z, so rows come out in the sparse
    middles' rank order and an overflow drops a scan-line suffix. Padding
    sorts last. Port of voxelize.py::_sort_key."""
    gx, gy, gz = grid_size
    if key_mode == "yxz":
        key = ((lin // gx) % gy * gx + lin % gx) * gz + lin // (gx * gy)
        return torch.where(lin == SENTINEL, SENTINEL, key)
    if key_mode != "hashed":
        raise ValueError(f"sorted voxel order {key_mode!r}: expected "
                         "'hashed' or 'yxz'")
    return torch.where(lin == SENTINEL, _U32, mix32(lin))


def voxelize_hashed(points, num_points, *, voxel_size, pc_range, grid_size,
                    max_voxels: int, max_points: int,
                    key_mode: str = "hashed"):
    """Voxelize a batch of padded clouds in a sorted voxel order: hashed,
    or yxz with ``key_mode="yxz"``.

    points: (B, P, C) float; num_points: (B,) int.
    Returns dict with voxels (B, V, T, C), coords (B, V, 3) int32 zyx (-1
    padded), num_points_per_voxel (B, V) int32, num_voxels (B,) int32.
    """
    b, p, c = points.shape
    gx, gy, _ = grid_size
    dev = points.device
    v_cap, t_cap = int(max_voxels), int(max_points)
    lin = quantize(points, num_points, voxel_size, pc_range, grid_size)

    # sort by (key, lin): one int64 key with the 32-bit key above the
    # 31-bit id; the stable sort keeps each voxel's points in input order
    key = sort_key(lin, grid_size, key_mode)
    sorted_key, perm = torch.sort((key << 31) | lin, dim=1, stable=True)
    sorted_lin = sorted_key & SENTINEL
    pos = torch.arange(p, device=dev).expand(b, p)

    svalid = sorted_lin != SENTINEL
    head = svalid.clone()
    head[:, 1:] &= sorted_lin[:, 1:] != sorted_lin[:, :-1]
    seg_id = torch.clamp(row_cumsum(head.to(torch.int64)) - 1, min=0)
    start = torch.cummax(torch.where(head, pos, 0), dim=1).values
    slot_p = pos - start

    write = svalid & (seg_id < v_cap) & (slot_p < t_cap)
    row = torch.arange(b, device=dev)[:, None] * v_cap + seg_id   # (B, P)
    sorted_pts = torch.gather(points, 1, perm[..., None].expand(b, p, c))
    voxels = scatter_rows(sorted_pts, row * t_cap + slot_p, write,
                          b * v_cap * t_cap).view(b, v_cap, t_cap, c)

    # head rows carry (z, y, x, start_pos); coords by delinearizing the id
    safe = torch.where(svalid, sorted_lin, 0)
    payload = torch.stack([safe // (gx * gy), (safe // gx) % gy, safe % gx,
                           pos], dim=-1)
    table = scatter_rows(payload, row, head & (seg_id < v_cap),
                         b * v_cap).view(b, v_cap, 4)

    num_voxels = torch.clamp(head.sum(dim=1), max=v_cap)
    vvalid = torch.arange(v_cap, device=dev)[None, :] < num_voxels[:, None]
    coords = torch.where(vvalid[..., None], table[..., :3], -1)

    # rows of kept segments form a sorted prefix of length n_kept; counts
    # are differences of consecutive starts
    n_kept = (svalid & (seg_id < v_cap)).sum(dim=1, keepdim=True)
    starts = torch.where(vvalid, table[..., 3], n_kept)
    ends = torch.cat([starts[:, 1:], n_kept], dim=1)
    counts = torch.where(vvalid, torch.clamp(ends - starts, 0, t_cap), 0)

    return {
        "voxels": voxels,
        "coords": coords.to(torch.int32),
        "num_points_per_voxel": counts.to(torch.int32),
        "num_voxels": num_voxels.to(torch.int32),
    }


def voxelize_mean(points, num_points, *, voxel_size, pc_range, grid_size,
                  max_voxels: int, max_points: int, order: str = "hashed"):
    """Fused voxelize + mean: each voxel's mean over its first
    ``max_points`` points, (B, V, C), in the hashed or yxz order, with the
    coords and counts of ``voxelize_hashed``. Port of
    voxelize.py::voxelize_mean.

    The sums run in slot order, one slot after another, as the reference's
    scatter-add sums a voxel's sorted points: no float atomics, so the
    result is the same on every run and in a captured graph."""
    out = voxelize_hashed(points, num_points, voxel_size=voxel_size,
                          pc_range=pc_range, grid_size=grid_size,
                          max_voxels=max_voxels, max_points=max_points,
                          key_mode=order)
    buf = out["voxels"]                                 # empty slots zero
    sums = buf[:, :, 0]
    for t in range(1, buf.shape[2]):
        sums = sums + buf[:, :, t]
    counts = out["num_points_per_voxel"]
    out["voxels"] = sums / torch.clamp(counts, min=1).to(sums.dtype)[..., None]
    return out


def voxelize_appearance(points, num_points, *, voxel_size, pc_range,
                        grid_size, max_voxels: int, max_points: int):
    """Voxelize a batch of padded clouds in appearance (first-come) voxel
    order; the same arguments and outputs as ``voxelize_hashed``.

    A stable sort by voxel id keeps each voxel's points in input order, so
    a segment's head holds its first point. The segments are ranked by
    that point (a second stable sort; segment ids that no point maps to
    hold SENTINEL and rank last), and the rank is the voxel's row."""
    b, p, c = points.shape
    gx, gy, _ = grid_size
    dev = points.device
    v_cap, t_cap = int(max_voxels), int(max_points)
    lin = quantize(points, num_points, voxel_size, pc_range, grid_size)

    sorted_lin, perm = torch.sort(lin, dim=1, stable=True)
    pos = torch.arange(p, device=dev).expand(b, p)
    svalid = sorted_lin != SENTINEL
    head = svalid.clone()
    head[:, 1:] &= sorted_lin[:, 1:] != sorted_lin[:, :-1]
    seg_id = torch.clamp(row_cumsum(head.to(torch.int64)) - 1, min=0)
    start = torch.cummax(torch.where(head, pos, 0), dim=1).values
    slot_p = pos - start

    # first original point of each segment (column p takes the non-heads)
    first = torch.full((b, p + 1), SENTINEL, dtype=torch.int64, device=dev)
    first.scatter_(1, torch.where(head, seg_id, p), perm)
    appear = torch.sort(first[:, :p], dim=1, stable=True).indices
    seg_rank = torch.empty_like(appear).scatter_(1, appear, pos)
    slot_v = torch.gather(seg_rank, 1, seg_id)

    write = svalid & (slot_v < v_cap) & (slot_p < t_cap)
    row = torch.arange(b, device=dev)[:, None] * v_cap + slot_v   # (B, P)
    sorted_pts = torch.gather(points, 1, perm[..., None].expand(b, p, c))
    voxels = scatter_rows(sorted_pts, row * t_cap + slot_p, write,
                          b * v_cap * t_cap).view(b, v_cap, t_cap, c)
    counts = torch.zeros(b, v_cap + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, torch.where(write, slot_v, v_cap),
                        write.to(torch.int64))

    safe = torch.where(svalid, sorted_lin, 0)
    zyx = torch.stack([safe // (gx * gy), (safe // gx) % gy, safe % gx], -1)
    table = scatter_rows(zyx, row, head & (slot_v < v_cap),
                         b * v_cap).view(b, v_cap, 3)
    num_voxels = torch.clamp(head.sum(dim=1), max=v_cap)
    vvalid = torch.arange(v_cap, device=dev)[None, :] < num_voxels[:, None]
    coords = torch.where(vvalid[..., None], table, -1)
    return {
        "voxels": voxels,
        "coords": coords.to(torch.int32),
        "num_points_per_voxel": counts[:, :v_cap].to(torch.int32),
        "num_voxels": num_voxels.to(torch.int32),
    }


@dataclass(frozen=True)
class VoxelGenerator:
    """Config-level voxelizer. Port of voxelize.py::VoxelGenerator.

    grid_size = round((range_max - range_min) / voxel_size), like the
    reference."""
    voxel_size: Sequence[float]
    point_cloud_range: Sequence[float]
    max_num_points: int
    max_voxels: int = 20000
    order: str = "hashed"
    fuse_mean: bool = False

    def __post_init__(self):
        if self.order not in ("hashed", "yxz", "appearance"):
            raise ValueError(f"voxel order {self.order!r}: expected "
                             "'hashed', 'yxz' or 'appearance'")

    @property
    def effective_order(self) -> str:
        """Voxel row order actually produced: the fused-mean path always
        sorts by a fast key ("yxz" or "hashed"). Host plans key off it."""
        if self.fuse_mean:
            return "yxz" if self.order == "yxz" else "hashed"
        return self.order

    def host_kwargs(self) -> dict:
        """Keyword arguments of ops/voxelize_host.py::host_voxelize."""
        return dict(voxel_size=tuple(float(v) for v in self.voxel_size),
                    pc_range=tuple(float(v) for v in self.point_cloud_range),
                    grid_size=self.grid_size,
                    max_voxels=int(self.max_voxels),
                    max_points=int(self.max_num_points),
                    order=self.order, fuse_mean=bool(self.fuse_mean))

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        vs = np.asarray(self.voxel_size, np.float64)
        rng = np.asarray(self.point_cloud_range, np.float64)
        g = np.round((rng[3:] - rng[:3]) / vs).astype(np.int64)
        return tuple(int(v) for v in g)

    def generate_batch(self, points, num_points):
        """(B, P, C) padded clouds and (B,) counts -> voxelize_hashed's
        dict, on the clouds' device: the fused mean in the effective
        order, else the (V, T, C) buffer in ``order``."""
        kw = dict(voxel_size=tuple(float(v) for v in self.voxel_size),
                  pc_range=tuple(float(v) for v in self.point_cloud_range),
                  grid_size=self.grid_size,
                  max_voxels=int(self.max_voxels),
                  max_points=int(self.max_num_points))
        if self.fuse_mean:
            return voxelize_mean(points, num_points,
                                 order=self.effective_order, **kw)
        if self.order == "appearance":
            return voxelize_appearance(points, num_points, **kw)
        return voxelize_hashed(points, num_points, key_mode=self.order, **kw)
