"""RoI ops of the two-stage refinement: points in boxes, the fixed-budget
point pooling and the rotated RoI Align.

Port of det3d_tpu/ops/roi.py (reference det3d/ops/roipool3d and
det3d/ops/rroi_align). The JAX package writes them as plain XLA programs,
not Pallas kernels, so plain PyTorch is their port: fixed shapes, no host
round trip, differentiable where the JAX functions are. Boxes are
LIDAR-frame (x, y, z, w, l, h, yaw) with a center origin; feature maps are
NHWC. ``roipool3d`` keeps the first ``sampled_pt_num`` in-box points in
point order, the reference kernel's sequential scan, through the smallest
keys of a top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def points_in_boxes3d(points, boxes, extra_width: float = 0.0):
    """points (..., N, 3), boxes (..., M, 7) -> (..., M, N) bool: the
    points inside each box, its w, l and h grown by ``extra_width``."""
    centers = boxes[..., :3]
    half = (boxes[..., 3:6] + extra_width) / 2.0              # (..., M, 3)
    yaw = boxes[..., 6]
    rel = points[..., None, :, :] - centers[..., :, None, :]  # (..., M, N, 3)
    # the inverse of core/box_ops.py::rotation_2d
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    return ((torch.abs(lx) <= half[..., 0, None])
            & (torch.abs(ly) <= half[..., 1, None])
            & (torch.abs(rel[..., 2]) <= half[..., 2, None]))


def _first_k_indices(mask, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (..., N) -> (idx (..., k) int64, found (..., k) bool): the
    first k True columns in column order, 0 where there are fewer."""
    n = mask.shape[-1]
    key = torch.where(mask, torch.arange(n, device=mask.device), n)
    idx = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    found = idx < n
    return torch.where(found, idx, 0), found


def roipool3d(points, feats, boxes, extra_width: float = 1.0,
              sampled_pt_num: int = 512, canonical: bool = True,
              valid: Optional[torch.Tensor] = None):
    """Pool the points (and features) inside enlarged RoIs, a fixed budget
    each: points (B, N, 3), feats (B, N, C) or None, boxes (B, M, 7),
    valid (B, N) or None -> (pooled_xyz (B, M, S, 3), pooled_feats (B, M,
    S, C) or None, empty (B, M)). ``canonical``: the points translated to
    the RoI's center and turned by -yaw (+x along the box's heading).
    Slots past a RoI's points are zero; ``empty`` marks RoIs with none."""
    mask = points_in_boxes3d(points, boxes, extra_width)     # (B, M, N)
    if valid is not None:
        mask = mask & valid[:, None, :]
    idx, found = _first_k_indices(mask, sampled_pt_num)     # (B, M, S)
    b, m, s = idx.shape
    flat = idx.reshape(b, m * s, 1)
    px = torch.gather(points, 1, flat.expand(-1, -1, 3)).view(b, m, s, 3)
    if canonical:
        px = px - boxes[..., None, :3]
        yaw = boxes[..., 6, None]
        c, sn = torch.cos(yaw), torch.sin(yaw)
        px = torch.stack([px[..., 0] * c - px[..., 1] * sn,
                          px[..., 0] * sn + px[..., 1] * c,
                          px[..., 2]], dim=-1)
    px = torch.where(found[..., None], px, 0.0)
    pf = None
    if feats is not None:
        pf = torch.gather(feats, 1, flat.expand(-1, -1, feats.shape[-1]))
        pf = torch.where(found[..., None], pf.view(b, m, s, -1), 0.0)
    return px, pf, ~found.any(dim=-1)


def _bilinear(feat, x, y):
    """feat (R, H, W, C) or (H, W, C); x, y (R, ...) or (...) continuous
    pixel coordinates -> (R, ..., C) or (..., C). Samples out of bounds
    contribute zero (the reference kernel's empty handling)."""
    single = feat.dim() == 3
    if single:
        feat, x, y = feat[None], x[None], y[None]
    r, h, w, c = feat.shape
    table = feat.reshape(r, h * w, c)
    inb = (x >= -1.0) & (x <= w * 1.0) & (y >= -1.0) & (y <= h * 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = 0.0
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            xi = torch.clamp(x0.long() + dx, 0, w - 1)
            yi = torch.clamp(y0.long() + dy, 0, h - 1)
            ok = (inb & (x0 + dx >= 0) & (x0 + dx <= w - 1)
                  & (y0 + dy >= 0) & (y0 + dy <= h - 1)).to(x.dtype)
            wt = ok * wy * wx
            g = torch.gather(table, 1, (yi * w + xi).reshape(r, -1, 1).expand(
                -1, -1, c)).view(*x.shape, c)
            out = out + torch.where((wt > 0)[..., None], g * wt[..., None],
                                    0.0)
    return out[0] if single else out


def rotated_roi_align(feat, rois, output_size: Tuple[int, int],
                      spatial_scale: float, sampling_ratio: int = 2):
    """Rotated RoI Align: feat (B, H, W, C) NHWC; rois (R, 6) = (batch
    index, cx, cy, w, h, angle) in input coordinates -> (R, ph, pw, C).
    Each bin averages ``sampling_ratio``^2 bilinear samples on a grid
    turned by the RoI's angle about its center. Differentiable in feat and
    rois (the reference needs a hand-written backward)."""
    ph, pw = output_size
    sr = max(int(sampling_ratio), 1)
    dev, dt = feat.device, feat.dtype
    step = (torch.arange(sr, device=dev, dtype=dt) + 0.5) / sr
    ys = ((torch.arange(ph, device=dev, dtype=dt)[:, None] + step).reshape(-1)
          / ph - 0.5)
    xs = ((torch.arange(pw, device=dev, dtype=dt)[:, None] + step).reshape(-1)
          / pw - 0.5)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # (ph*sr, pw*sr)
    bidx = rois[:, 0].long()
    cx, cy, rw, rh = (rois[:, i, None, None] * spatial_scale
                      for i in range(1, 5))
    ang = rois[:, 5, None, None]
    lx, ly = gx * rw, gy * rh
    c, s = torch.cos(ang), torch.sin(ang)
    sx = cx + lx * c - ly * s - 0.5
    sy = cy + lx * s + ly * c - 0.5
    samples = _bilinear(feat[bidx], sx, sy)             # (R, ph*sr, pw*sr, C)
    r = rois.shape[0]
    return samples.view(r, ph, sr, pw, sr, -1).mean(dim=(2, 4))
