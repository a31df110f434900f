"""Rotated-NMS keep mask: the CUDA kernel's wrapper and its plain twin.

``rotated_nms_keep`` replaces det3d_tpu/ops/nms_pallas.py::rotated_nms_keep
(the Pallas TPU kernel). A CUDA tensor launches the hand-written kernel in
``csrc/rotated_nms.cu``; a CPU tensor takes ``rotated_nms_keep_ref``, the
same function in plain PyTorch (the reference's
``_pairwise_rotated_iou_from_corners`` plus ``_greedy_suppress``,
det3d_tpu/ops/nms.py:38-86). There is no fallback between the two.

Both take the boxes as CCW corners with their shoelace areas, computed in
torch by the caller, as the JAX wrapper computes them outside its
``pallas_call``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch import csrc
from det3d_tpu_torch.utils import flops
from det3d_tpu_torch.core.geometry import _clip_contrib

_BLOCK = 64                     # boxes per bitmask word (rotated_nms.cu)
# Largest K the kernel takes: its scan stages two blocks of 64 rows x
# ceil(K/64) mask words in shared memory, 232,200 of the 232,448 bytes a
# block may have on an H100 (rotated_nms.cu, rotated_nms_max_k()).
MAX_K = 14400
CULL_SCALE = 1.0001             # rotated_nms.cu kCullScale


def pairwise_iou_from_corners(corners, area):
    """corners (N, K, 8) CCW, area (N, K) -> (N, K, K) IoU, row i vs col j."""
    px = [corners[:, :, None, 2 * v] for v in range(4)]
    py = [corners[:, :, None, 2 * v + 1] for v in range(4)]
    qx = [corners[:, None, :, 2 * v] for v in range(4)]
    qy = [corners[:, None, :, 2 * v + 1] for v in range(4)]
    total = (_clip_contrib(px, py, qx, qy, open_side=False)
             + _clip_contrib(qx, qy, px, py, open_side=True))
    inter = torch.clamp(0.5 * total, min=0.0)
    union = area[:, :, None] + area[:, None, :] - inter
    return torch.where(union > 0,
                       inter / torch.where(union > 0, union, 1.0), 0.0)


def greedy_suppress(iou, valid, iou_threshold):
    """Greedy NMS keep mask over score-descending rows, (N, K, K) -> (N, K).

    Iterates ``keep = valid & ~any_i(keep[i] & sup[i, j])`` to its fixpoint,
    which is the unique greedy solution (the suppression relation is
    strictly upper triangular). Port of ops/nms.py::_greedy_suppress."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    sup = ((iou > iou_threshold) & (idx[:, None] < idx[None, :])
           & valid[:, :, None] & valid[:, None, :])
    keep = valid
    for _ in range(k):
        new = valid & ~(sup & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def near_pairs(corners, area, valid):
    """(N, K, K) bool: the pairs (i < j, both valid) that the kernel's cull
    keeps for the full IoU when the threshold is >= 0, in the kernel's fp32
    operations. A pair is culled when both areas are > 0 and the squared
    distance of the circumcircle centres exceeds (r_i + r_j)^2 (1 + 1e-4):
    the centre is the midpoint of corners 0 and 2, the radius the distance
    to the farthest corner."""
    x, y = corners[..., 0::2], corners[..., 1::2]                # (N, K, 4)
    cx = 0.5 * (x[..., 0] + x[..., 2])
    cy = 0.5 * (y[..., 0] + y[..., 2])
    ddx, ddy = x - cx[..., None], y - cy[..., None]
    r = torch.sqrt((ddx * ddx + ddy * ddy).amax(dim=-1))
    dx = cx[:, :, None] - cx[:, None, :]
    dy = cy[:, :, None] - cy[:, None, :]
    s = r[:, :, None] + r[:, None, :]
    pos = area > 0
    far = ((dx * dx + dy * dy > s * s * CULL_SCALE)
           & pos[:, :, None] & pos[:, None, :])
    pair = torch.triu(valid[:, :, None] & valid[:, None, :], diagonal=1)
    return pair & ~far


def rotated_nms_keep_ref(corners, area, valid, iou_threshold: float):
    """Plain PyTorch twin of the CUDA kernel. corners (N, K, 8) f32 CCW,
    area (N, K) f32, valid (N, K) bool -> keep (N, K) bool."""
    return greedy_suppress(pairwise_iou_from_corners(corners, area), valid,
                           iou_threshold)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = csrc.load("rotated_nms")
    fn = lib.rotated_nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.rotated_nms_max_k() != MAX_K:
        raise RuntimeError(f"rotated_nms.cu takes K up to "
                           f"{lib.rotated_nms_max_k()}, MAX_K says {MAX_K}")
    return lib


def _check(corners, area, valid):
    dev = corners.device
    if dev.type != "cuda":
        raise ValueError(f"rotated_nms_keep: no kernel for device {dev}")
    if corners.dim() != 3 or corners.shape[-1] != 8:
        raise ValueError(f"corners must be (N, K, 8), got {tuple(corners.shape)}")
    n, k = corners.shape[:2]
    for name, t, dtype in (("corners", corners, torch.float32),
                           ("area", area, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, corners on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(area.shape) != (n, k) or tuple(valid.shape) != (n, k):
        raise ValueError(f"area {tuple(area.shape)} and valid "
                         f"{tuple(valid.shape)} must be ({n}, {k})")
    if k > MAX_K:
        raise ValueError(f"K={k} boxes exceed the kernel's limit of {MAX_K} "
                         f"(its scan's shared memory); pass at most {MAX_K}")


def rotated_nms_keep(corners, area, valid, iou_threshold: float):
    """Greedy rotated-NMS keep mask for N independent samples.

    corners: (N, K, 8) f32, CCW, boxes in score-descending order.
    area: (N, K) f32 shoelace areas. valid: (N, K) bool.
    Returns keep: (N, K) bool.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for all N samples, counted in ``rotated_nms_keep.launches``);
    any other input raises. Counted by utils/flops.py's nms_work rule.
    """
    with flops.kernel("rotated_nms_keep", corners, area, valid):
        return _keep(corners, area, valid, iou_threshold)


def _keep(corners, area, valid, iou_threshold):
    if corners.device.type == "cpu":
        return rotated_nms_keep_ref(corners, area, valid, iou_threshold)
    _check(corners, area, valid)
    n, k = valid.shape
    keep = torch.empty((n, k), dtype=torch.bool, device=corners.device)
    if n == 0 or k == 0:
        return keep
    w = -(-k // _BLOCK)
    mask = torch.empty((n, w * _BLOCK, w), dtype=torch.int64,
                       device=corners.device)
    with torch.cuda.device(corners.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rotated_nms_keep_launch(
            corners.data_ptr(), area.data_ptr(), valid.data_ptr(), n, k,
            float(iou_threshold), mask.data_ptr(), keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rotated_nms_keep: CUDA launch failed "
                           f"(cudaError {err})")
    rotated_nms_keep.launches += 1
    return keep


rotated_nms_keep.launches = 0

flops.register("rotated_nms_keep",
               lambda corners, area, valid: (*flops.nms_work(
                   corners, area, valid), flops.FP32_FLOPS))
