"""PointNet++ primitive ops: farthest-point sampling, ball query, grouping,
3-NN interpolation.

Port of det3d_tpu/ops/pointnet2.py (reference det3d/ops/pointnet2/
pointnet2_utils.py). The JAX package writes them as plain XLA programs,
not Pallas kernels, so plain PyTorch is their port. Layout is
channels-last, (B, N, C), and every op takes the optional ``valid`` mask
of padded fixed-shape clouds. Indices are int64, torch's index type.

- ``square_distance`` is the expanded ``max(|a|^2 - 2ab + |b|^2, 0)`` with
  an explicit product, as in the JAX package: ball-query membership and
  the 3-NN order are decided on it (``torch.cdist`` chooses its own method
  and returns the root).
- ``furthest_point_sample`` starts from the first valid point, keeps the
  running minimum of the differences form ``sum((xyz - cur)^2)`` with
  invalid points at -inf, and takes its first maximal index each step
  (``torch.argmax``, as ``jnp.argmax``). Its loop makes no tensor from host
  data, so a step that runs it can be captured in a CUDA graph.
- ``ball_query`` keeps the first ``nsample`` in-ball indices in point order
  (the smallest index keys of a sorted top-k), pads with the first hit,
  gives index 0 to an empty ball, and returns ``found``; centers go
  ``chunk`` at a time, so a tile holds chunk x N distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: a (..., M, D), b (..., N, D) -> (..., M, N)."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(a2 - 2.0 * ab + b2, min=0.0)


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Iterative farthest-point sampling. xyz (B, N, 3) -> (B, npoint).

    Past the valid count the selection repeats the first index of the
    largest remaining (-inf) distance, as in the JAX package."""
    b, n = xyz.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    invalid = ~valid
    sel = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    sel[:, 0] = valid.to(torch.uint8).argmax(1)
    dist = torch.full((b, n), float("inf"), dtype=xyz.dtype,
                      device=xyz.device).masked_fill_(invalid, float("-inf"))
    for m in range(1, npoint):
        last = sel[:, m - 1:m, None].expand(b, 1, xyz.shape[-1])
        cur = torch.gather(xyz, 1, last)                        # (B, 1, 3)
        d = ((xyz - cur) ** 2).sum(-1).masked_fill_(invalid, float("-inf"))
        torch.minimum(dist, d, out=dist)
        sel[:, m] = dist.argmax(1)
    return sel


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(features, 1, idx[:, :, None].expand(
        *idx.shape, features.shape[-1]))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = gather_points(features, idx.reshape(b, m * s))
    return flat.reshape(b, m, s, features.shape[-1])


def _ball_query_tile(d2, valid, r2, nsample):
    """d2 (B, M', N), valid (B, N) -> the first-nsample in-ball indices
    (B, M', nsample) and ``found``."""
    n = d2.shape[-1]
    inball = (d2 < r2) & valid[:, None, :]
    order = torch.arange(n, device=d2.device)
    key = torch.where(inball, order, n)
    idx = torch.topk(key, nsample, dim=-1, largest=False, sorted=True)[0]
    found = idx < n
    idx = torch.where(found, idx, idx[..., :1])      # pad with the first hit
    return idx.masked_fill_(idx == n, 0), found      # empty ball -> index 0


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int, valid: Optional[torch.Tensor] = None,
               chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (idx (B, M, nsample),
    found (B, M, nsample) bool)."""
    b, n = xyz.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    # the JAX package compares fp32 distances with radius^2 rounded to fp32
    r2 = float(np.float32(radius * radius))
    tiles = [_ball_query_tile(square_distance(new_xyz[:, s:s + chunk], xyz),
                              valid, r2, nsample)
             for s in range(0, new_xyz.shape[1], chunk)]
    return (torch.cat([t[0] for t in tiles], 1),
            torch.cat([t[1] for t in tiles], 1))


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unknown (B, M, 3), known (B, N, 3) -> (dist (B, M, 3), idx (B, M, 3)):
    the 3 nearest valid known points, Euclidean distances ascending."""
    d2 = square_distance(unknown, known)                          # (B, M, N)
    if valid is not None:
        d2 = d2.masked_fill(~valid[:, None, :], float("inf"))
    near, idx = torch.topk(d2, 3, dim=-1, largest=False, sorted=True)
    return torch.sqrt(torch.clamp(near, min=0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), idx (B, M, 3), weight (B, M, 3) -> (B, M, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(2)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8
                          ) -> torch.Tensor:
    """Inverse-distance weights over the 3 NN: (1/d_i) / sum_j (1/d_j)."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)
