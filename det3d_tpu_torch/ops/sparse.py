"""Sparse 3-D convolution over window rulebooks, plan-fed evaluation subset.

Port of det3d_tpu/ops/sparse.py: coordinate helpers, the packed window
format, ``to_dense`` and the forward of the window convolution, whose
plain PyTorch form ``window_conv_ref`` is the twin of the CUDA kernel in
``csrc/window_conv.cu`` (ops/window_conv_cuda.py). The device rulebook
builders and the backward passes are not ported: the serving path reads
host-built plans (ops/sparse_host.py).

Active voxels live in fixed-size padded arrays: features (B, V, C), coords
(B, V, 3) int32 zyx with -1 rows for padding, rows in (y, x, z) rank
order. A window rulebook holds, per output row o and BEV kernel column k,
the rank r0 of the first input row of the column's z-window and the
presence of its kz taps: the present taps of one column are consecutive
ranks starting at r0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from det3d_tpu_torch.core.voxelize import scatter_rows

_SENTINEL = int(np.iinfo(np.int32).max)
_PACK_SHIFT = 24
_PACK_MASK = (1 << _PACK_SHIFT) - 1


def _as3(v) -> Tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v),) * 3
    t = tuple(int(x) for x in v)
    assert len(t) == 3
    return t


def out_spatial_shape(shape, kernel, stride, padding) -> Tuple[int, int, int]:
    """Standard conv output dims: floor((D + 2p - k)/s) + 1, per zyx dim."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    return tuple((shape[d] + 2 * p[d] - k[d]) // s[d] + 1 for d in range(3))


def linearize(coords, shape):
    """(..., 3) int zyx -> (...,) int64 linear ids; padding -> sentinel."""
    d, h, w = shape
    z, y, x = (coords[..., i].long() for i in range(3))
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return torch.where(ok, (z * h + y) * w + x, _SENTINEL)


def delinearize(lin, shape):
    """(...,) linear ids -> (..., 3) int32 zyx; sentinel -> -1 rows."""
    d, h, w = shape
    lin = lin.long()
    ok = lin != _SENTINEL
    safe = torch.where(ok, lin, 0)
    out = torch.stack([safe // (h * w), (safe // w) % h, safe % w], dim=-1)
    return torch.where(ok[..., None], out, -1).to(torch.int32)


def unpack_windows(packed, kz: int):
    """Packed window words (..., K) int32 -> (r0 (..., K) int64,
    pres (..., K, kz) bool)."""
    r0 = (packed & _PACK_MASK).long()
    pres = torch.stack([((packed >> (_PACK_SHIFT + j)) & 1).bool()
                        for j in range(kz)], dim=-1)
    return r0, pres


def to_dense(features, coords, shape):
    """Scatter active voxels (B, V, C) at coords (B, V, 3) zyx onto a dense
    (B, D, H, W, C) canvas. Padded rows are masked out before the scatter
    (the reference sends them to an out-of-bounds index that XLA drops)."""
    d, h, w = shape
    b, v, c = features.shape
    lin = linearize(coords, shape)
    keep = lin != _SENTINEL
    base = torch.arange(b, device=lin.device)[:, None] * (d * h * w)
    dense = scatter_rows(features, base + torch.where(keep, lin, 0), keep,
                         b * d * h * w)
    return dense.view(b, d, h, w, c)


# ---------------------------------------------------------------------------
# Window convolution, plain version (the CUDA kernel's twin)
# ---------------------------------------------------------------------------


def _window_taps(fpad, r0, pres):
    """One BEV column's kz masked taps, batched.

    fpad: (B, V + kz - 1, C), zero rows at the end; r0: (B, O) window
    starts clamped to V-1; pres: (B, O, kz). Gathers the kz rows from r0,
    then routes window row popcount(pres[:j]) to tap j. Returns kz
    (B, O, C)."""
    kz = pres.shape[-1]
    c = fpad.shape[-1]
    rows = r0[:, :, None] + torch.arange(kz, device=r0.device)
    b, o = r0.shape
    g = torch.gather(fpad, 1, rows.reshape(b, o * kz, 1).expand(-1, -1, c))
    g = g.view(b, o, kz, c)
    taps = []
    off = torch.zeros_like(r0)                      # popcount so far
    for j in range(kz):
        sel = g[:, :, 0]
        for m in range(1, j + 1):
            sel = torch.where((off == m)[..., None], g[:, :, m], sel)
        taps.append(sel * pres[:, :, j, None].to(sel.dtype))
        off = off + pres[:, :, j].long()
    return taps


def _center_taps(features, pres_cc):
    """The center BEV column's three taps by rank shifts (submanifold
    rulebooks: rows rank-aligned with outputs, so the z-1 / z+1 neighbour
    is the previous / next row)."""
    zero = torch.zeros_like(features[:, :1])
    shifted = (torch.cat([zero, features[:, :-1]], dim=1), features,
               torch.cat([features[:, 1:], zero], dim=1))
    return [g * pres_cc[..., j, None].to(g.dtype)
            for j, g in enumerate(shifted)]


def _split_cols(r0, pres, weights, center_shift):
    """Per-column weights (K, kz, Cin, Cout), the columns that gather, and
    the center column."""
    kbev = r0.shape[-1]
    kz = pres.shape[-1]
    cin, cout = weights.shape[-2:]
    w_cols = weights.reshape(kz, kbev, cin, cout).transpose(0, 1)
    cols = list(range(kbev))
    cc = kbev // 2
    if center_shift:
        assert kz == 3, "center_shift needs a kz=3 submanifold rulebook"
        cols.remove(cc)
    return w_cols, cols, cc


def _mm(tap, w):
    """(B, O, Cin) @ (Cin, Cout) with fp32 products and sums, whatever the
    operands' type (bf16 -> fp32 is exact)."""
    return torch.matmul(tap.float(), w.float())


def window_conv_ref(features, r0, pres, weights, center_shift: bool):
    """Sparse conv over a window rulebook, plain PyTorch.

    features: (B, V, Cin) fp32 or bf16; r0: (B, O, K) int; pres:
    (B, O, K, kz) bool; weights: (kz*K, Cin, Cout) z-major (tap (k, j) is
    row j*K + k), the features' type. Returns (B, O, Cout) fp32.

    Tap j of column k reads input row min(r0, V-1) + popcount(pres[:j])
    where pres[j]; rows past V read zero. ``center_shift`` (submanifold,
    O == V): the center column reads rows o-1, o, o+1 instead."""
    b, o, _ = r0.shape
    v = features.shape[1]
    kz = pres.shape[-1]
    cout = weights.shape[-1]
    w_cols, cols, cc = _split_cols(r0, pres, weights, center_shift)

    out = torch.zeros((b, o, cout), dtype=torch.float32,
                      device=features.device)
    if center_shift:
        assert o == v
        for j, tap in enumerate(_center_taps(features, pres[:, :, cc])):
            out = out + _mm(tap, w_cols[cc, j])
    if v == 0:
        return out
    # kz-1 zero rows make every clamped window (r0 <= V-1) in bounds
    fpad = torch.cat([features, features.new_zeros(
        (b, kz - 1, features.shape[-1]))], dim=1)
    r0c = torch.clamp(r0.long(), max=v - 1)
    for k in cols:
        for j, tap in enumerate(_window_taps(fpad, r0c[:, :, k],
                                             pres[:, :, k])):
            out = out + _mm(tap, w_cols[k, j])
    return out
