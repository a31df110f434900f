"""Sparse 3-D convolution over window rulebooks.

Port of det3d_tpu/ops/sparse.py: coordinate helpers, the packed window
format, ``to_dense``, the window convolution and its backward, and the
device rulebook builders of the bitmap regime (depth <= 64):
``yxz_order``, ``build_bitmap_batch``, the window rulebooks,
``conv_out_coords``, ``stage_lookup_batch``, ``pack_windows``, and the
strided conv's inverse rulebook of training
(``strided_inverse_rulebook_batch``, ``pack_inverse``). They are plain
PyTorch with fixed shapes and no host round trip, so a captured step
holds them, and give the host builders' plans (ops/sparse_host.py) array
for array.

The convolution's plain PyTorch forms are the twins of the CUDA kernels
(ops/window_conv_cuda.py): ``window_conv_ref`` of ``csrc/window_conv.cu``
(also the submanifold conv's dX, with mirrored, transposed weights),
``window_conv_dw_ref`` and ``window_conv_inv_ref`` of
``csrc/window_conv_bwd.cu``.

Grids deeper than 64 (the deep-grid fallbacks): ``stage_lookup_batch``
builds a dense slot table (``build_dense_table``, up to
``_DENSE_TABLE_MAX_CELLS`` cells) or a sorted one (``build_hash``), and
the window rulebook builders then return flat per-tap (idx, mask)
rulebooks, which ``flat_conv`` (the JAX package's ``apply_conv`` flat
branch: XLA there, plain PyTorch here) convolves; autograd's scatter-add
is their backward. ``window_to_flat`` and ``flat_conv_dx`` give the dX of
a strided window conv without an inverse rulebook (ncand > 2). The JAX
package's sort-free transition (``stage_transition_batch``) is switched
off there (``_SORT_FREE_TRANSITION = False``) and has no counterpart.

Active voxels live in fixed-size padded arrays: features (B, V, C), coords
(B, V, 3) int32 zyx with -1 rows for padding, rows in (y, x, z) rank
order. A window rulebook holds, per output row o and BEV kernel column k,
the rank r0 of the first input row of the column's z-window and the
presence of its kz taps: the present taps of one column are consecutive
ranks starting at r0.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from det3d_tpu_torch.core.voxelize import row_cumsum, scatter_rows

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


def _acc_dtype(dtype):
    """The type the plain versions sum in: fp32 for fp32 and bf16
    operands (bf16 -> fp32 is exact), fp64 for fp64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _mm(tap, w):
    """(B, O, Cin) @ (Cin, Cout) with products and sums in _acc_dtype,
    whatever the operands' type."""
    dt = _acc_dtype(tap.dtype)
    return torch.matmul(tap.to(dt), w.to(dt))


def window_conv_ref(features, r0, pres, weights, center_shift: bool):
    """Sparse conv over a window rulebook, plain PyTorch.

    features: (B, V, Cin) fp32 or bf16; r0: (B, O, K) int; pres:
    (B, O, K, kz) bool; weights: (kz*K, Cin, Cout) z-major (tap (k, j) is
    row j*K + k), the features' type. Returns (B, O, Cout) fp32 (fp64 for
    fp64 operands).

    Tap j of column k reads input row min(r0, V-1) + popcount(pres[:j])
    where pres[j]; rows past V read zero. ``center_shift`` (submanifold,
    O == V): the center column reads rows o-1, o, o+1 instead."""
    b, o, _ = r0.shape
    v = features.shape[1]
    kz = pres.shape[-1]
    cout = weights.shape[-1]
    w_cols, cols, cc = _split_cols(r0, pres, weights, center_shift)

    out = torch.zeros((b, o, cout), dtype=_acc_dtype(features.dtype),
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


# ---------------------------------------------------------------------------
# Window convolution backward, plain versions (the CUDA kernels' twins)
# ---------------------------------------------------------------------------
# A submanifold rulebook is its own transpose (tap m of row o reads row i
# <=> tap kvol-1-m of row i reads row o, with equal presence), so its dX is
# the forward over dY with the taps mirrored and the weights transposed:
# window_conv_ref(dy, r0, pres, weights.flip(0).transpose(1, 2), True). A
# strided conv's dX gathers dY over the inverse rulebook
# (window_conv_inv_ref); both convs' dW re-gathers the forward's taps
# (window_conv_dw_ref).


def window_conv_dw_ref(features, r0, pres, dy, center_shift: bool):
    """d(weights) of window_conv_ref, plain PyTorch: for every tap (k, j),
    dW[j*K + k] = sum over (b, o) of x[tap row]^T dy[o], the rows the
    forward reads (the center column's o-1, o, o+1 with ``center_shift``).

    features: (B, V, Cin); r0 (B, O, K); pres (B, O, K, kz); dy (B, O,
    Cout). Returns (kz*K, Cin, Cout) z-major, summed in fp32 (fp64 for
    fp64 operands). Twin of det3d_tpu/ops/sparse.py::_window_conv_dw."""
    b, o, kbev = r0.shape
    kz = pres.shape[-1]
    v, cin = features.shape[1:]
    cout = dy.shape[-1]
    dt = _acc_dtype(features.dtype)
    dyf = dy.to(dt)
    dw = torch.zeros((kbev, kz, cin, cout), dtype=dt, device=dy.device)
    cc = kbev // 2
    cols = [k for k in range(kbev) if not (center_shift and k == cc)]

    def contract(tap):
        return torch.einsum("boc,bod->cd", tap.to(dt), dyf)

    if center_shift:
        assert kz == 3 and o == v
        for j, tap in enumerate(_center_taps(features, pres[:, :, cc])):
            dw[cc, j] = contract(tap)
    if v > 0:
        fpad = torch.cat([features, features.new_zeros(
            (b, kz - 1, cin))], dim=1)
        r0c = torch.clamp(r0.long(), max=v - 1)
        for k in cols:
            for j, tap in enumerate(_window_taps(fpad, r0c[:, :, k],
                                                 pres[:, :, k])):
                dw[k, j] = contract(tap)
    return dw.transpose(0, 1).reshape(kz * kbev, cin, cout)


def ncand_of(kernel, stride):
    """Output candidates per dim of one input voxel: ceil(k / s)."""
    k, s = _as3(kernel), _as3(stride)
    return tuple(-(-k[d] // s[d]) for d in range(3))


def window_conv_inv_ref(dy, r0i, presi, par, weights, kernel, stride):
    """d(features) of a strided window conv over its inverse rulebook,
    plain PyTorch:

        dX[q] = sum over taps kk of parmask_kk(q) * dY[row_kk(q)] @ W[kk]^T

    where tap kk = (jz, jy, jx) reaches candidate c = j // s per dim,
    row_kk(q) is window tap m = ncz-1-cz of candidate column cy*ncx + cx
    (min(r0i, O-1) + popcount(presi[:m]), present where presi[m]; rows past
    O read zero), and parmask_kk(q) holds where par(q) == j mod s.

    dy: (B, O, Cout); r0i (B, V, Kc); presi (B, V, Kc, ncz); par (B, V, 3);
    weights (kvol, Cin, Cout) z-major. Returns (B, V, Cin) in fp32 (fp64
    for fp64 operands). Twin of det3d_tpu/ops/sparse.py::
    _strided_inverse_df (dX only)."""
    k3, s3 = _as3(kernel), _as3(stride)
    nc = ncand_of(k3, s3)
    b, v, kc = r0i.shape
    o, cout = dy.shape[1:]
    cin = weights.shape[1]
    dt = _acc_dtype(dy.dtype)
    out = torch.zeros((b, v, cin), dtype=dt, device=dy.device)
    if o == 0:
        return out
    dy_pad = torch.cat([dy, dy.new_zeros((b, max(nc[0] - 1, 1), cout))],
                       dim=1)
    r0c = torch.clamp(r0i.long(), max=o - 1)
    rows = [_window_taps(dy_pad, r0c[:, :, ci], presi[:, :, ci])
            for ci in range(kc)]
    for kk in range(weights.shape[0]):
        jz = kk // (k3[1] * k3[2])
        jy = (kk // k3[2]) % k3[1]
        jx = kk % k3[2]
        cz, cy, cx = jz // s3[0], jy // s3[1], jx // s3[2]
        if cz >= nc[0] or cy >= nc[1] or cx >= nc[2]:
            continue                                    # tap unreachable
        pm = ((par[..., 0] == jz % s3[0]) & (par[..., 1] == jy % s3[1])
              & (par[..., 2] == jx % s3[2]))
        row = rows[cy * nc[2] + cx][nc[0] - 1 - cz] * pm[..., None].to(
            dy.dtype)
        out = out + _mm(row, weights[kk].transpose(0, 1))
    return out


# ---------------------------------------------------------------------------
# Device rulebook builders: the bitmap lookup (depth <= 64)
# ---------------------------------------------------------------------------
# Ranks number the active voxels of a resolution in (y, x, z) order, so a
# BEV column's actives hold consecutive ranks. The bitmap keeps, per BEV
# column, the rank base of its first active voxel and its z occupancy in
# 32-bit words; a tap's rank is base + popcount(bits below z). Words are
# held in int64 tensors (values 0 .. 2^32 - 1): torch has no popcount and
# shifts only part of uint32, and int64 runs alike on the CPU and the card.

_U32 = 0xFFFFFFFF
# guard columns around the interleaved table: column c's words live at
# (c + _BM_PAD_FRONT) * stride
_BM_PAD_FRONT = 1
_BM_PAD_END = 3
MAX_BITMAP_DEPTH = 64


def check_depth(d: int):
    """Raise for a grid the bitmap lookup cannot hold (the host plans'
    contract; the device builders take deeper grids through
    build_lookup_batch)."""
    if not 0 < int(d) <= MAX_BITMAP_DEPTH:
        raise ValueError(f"depth {d}: the bitmap lookup (and every host "
                         f"plan) holds depths 1 to {MAX_BITMAP_DEPTH}; "
                         f"deeper grids take the device plan's dense or "
                         f"sorted lookup")


def popcount32(x):
    """Set bits of each 32-bit word held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def _tap_offsets_bev(ky: int, kx: int, device):
    """(Kbev,) dy and dx of a kernel's BEV columns in (jy, jx) row-major
    order, from ``arange`` (no host copy)."""
    t = torch.arange(ky * kx, device=device)
    return t // kx, t % kx


def yxz_lin(coords, shape):
    """(..., 3) zyx -> (...,) int64 yxz-major rank keys; invalid rows ->
    sentinel."""
    d, h, w = shape
    z, y, x = (coords[..., i].long() for i in range(3))
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return torch.where(ok, (y * w + x) * d + z, _SENTINEL)


def yxz_order(coords, shape):
    """(B, V, 3) -> (B, V) int64 row permutation into rank order (stable:
    padding rows keep their order, last)."""
    return torch.sort(yxz_lin(coords, shape), dim=-1, stable=True).indices


def bitmap_stride(d: int) -> int:
    """Words per column in the interleaved table: [base, lo] for d <= 32,
    [base, lo, hi, 0] for d in (32, 64]."""
    return 4 if d > 32 else 2


def build_bitmap_batch(coords, shape):
    """(B, V, 3) zyx rows in rank order -> (B, stride * (1 + h*w + 3))
    int64 interleaved tables: per BEV column its exclusive rank base and
    its z-bits 0..31 (and 32..63), guard columns in front and behind.

    One scatter-add for the batch, at per-sample column offsets; each
    active voxel owns a distinct (column, bit), so add == or. Padding rows
    add nothing to one spare column per sample."""
    d, h, w = shape
    check_depth(d)
    b = coords.shape[0]
    n = h * w
    z, y, x = (coords[..., i].long() for i in range(3))
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    col = (torch.where(ok, y * w + x, n)
           + torch.arange(b, device=coords.device)[:, None] * (n + 1))
    zc = torch.where(ok, z, 0)
    one = torch.ones_like(zc)
    words = []
    for lo_half in ((True, False) if d > 32 else (True,)):
        in_word = ok & ((zc < 32) if lo_half else (zc >= 32))
        bit = torch.where(in_word, one << (zc if lo_half else zc - 32), 0)
        t = torch.zeros(b * (n + 1), dtype=torch.int64, device=coords.device)
        t.scatter_add_(0, col.reshape(-1), bit.reshape(-1))
        words.append(t.view(b, n + 1)[:, :n])
    counts = sum(popcount32(t) for t in words)
    base = row_cumsum(counts) - counts
    parts = [base] + words
    if d > 32:
        parts.append(torch.zeros_like(base))
    table = torch.stack(parts, dim=-1)                  # (B, n, stride)
    table = torch.nn.functional.pad(table, (0, 0, _BM_PAD_FRONT, _BM_PAD_END))
    return table.reshape(b, -1)


def _bitmap_fetch(table, flat, d):
    """One (stride,)-word fetch per column query -> (base, lo, hi).

    table: (B, stride*M) from build_bitmap_batch; flat: (B, ...) in-range
    column ids (callers send out-of-range queries to 0). The batch is
    flattened into one gather at per-sample offsets; a slice start past
    either end is clamped so the slice stays in bounds, as XLA's CLIP
    gather mode does. hi is None for d <= 32."""
    s = bitmap_stride(d)
    bsz, sm = table.shape
    off = (torch.arange(bsz, device=flat.device) * (sm // s)).view(
        (bsz,) + (1,) * (flat.dim() - 1))
    start = ((flat.long() + off + _BM_PAD_FRONT) * s).clamp(0, bsz * sm - s)
    idx = start[..., None] + torch.arange(s, device=flat.device)
    g = table.reshape(-1).gather(0, idx.reshape(-1)).view(idx.shape)
    return g[..., 0], g[..., 1], (g[..., 2] if d > 32 else None)


def _windows_from_words(base, lo, hi, okc, z0, kz, d):
    """Window base rank + per-tap presence from fetched column words.

    base/lo/hi/okc: (...,) per column; z0 broadcasts against them. Returns
    (r0 (...,) int64, pres (..., kz) bool)."""
    z0 = torch.broadcast_to(z0, okc.shape)
    one = torch.ones_like(z0)

    def below(z):
        zc = z.clamp(0, d - 1)
        m_lo = torch.where(zc < 32, (one << zc.clamp(max=31)) - 1, _U32)
        n = popcount32(lo & m_lo)
        if d > 32:
            m_hi = torch.where(zc >= 32, (one << (zc - 32).clamp(min=0)) - 1,
                               0)
            n = n + popcount32(hi & m_hi)
        return n

    def present(z):
        okz = okc & (z >= 0) & (z < d)
        zc = torch.where(okz, z, 0)
        if d > 32:
            word = torch.where(zc < 32, lo, hi)
            bit = torch.where(zc < 32, zc, zc - 32)
        else:
            word, bit = lo, zc
        return okz & (((word >> bit) & 1) != 0)

    r0 = torch.where(okc, base + below(z0), 0)
    pres = torch.stack([present(z0 + j) for j in range(kz)], dim=-1)
    return r0, pres


def _bitmap_column_windows(bitmap, qy, qx, z0, kz, shape):
    """Per-column window base + tap presence, one fetch per column query.
    qy/qx: (B, ...) BEV column queries; z0: first z tap. Returns
    (r0 (B, ...), pres (B, ..., kz))."""
    d, h, w = shape
    okc = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
    flat = torch.where(okc, qy * w + qx, 0)
    base, lo, hi = _bitmap_fetch(bitmap, flat, d)
    return _windows_from_words(base, lo, hi, okc, z0, kz, d)


def subm_window_rulebook_batch(coords, shape, kernel, bitmap):
    """Window rulebook of a submanifold conv (output set == input set).

    coords: (B, V, 3) zyx in rank order; bitmap: build_bitmap_batch of
    them. Returns (r0 (B, V, Kbev), pres (B, V, Kbev, kz)). A deep grid's
    lookup (build_lookup_batch's tuple) gives the flat per-tap rulebook
    instead (subm_rulebook_batch: idx, mask (B, V, K)), as the JAX
    package's does."""
    if not torch.is_tensor(bitmap):
        return subm_rulebook_batch(coords, shape, kernel, bitmap)
    k = _as3(kernel)
    pad = tuple(kk // 2 for kk in k)
    dy, dx = _tap_offsets_bev(k[1], k[2], coords.device)
    co = coords.long()
    qy = co[..., 1, None] + (dy - pad[1])               # (B, V, Kbev)
    qx = co[..., 2, None] + (dx - pad[2])
    z0 = (co[..., 0] - pad[0])[..., None]
    r0, pres = _bitmap_column_windows(bitmap, qy, qx, z0, k[0], shape)
    return r0, pres & (co[..., 0] >= 0)[..., None, None]


def conv_window_rulebook_batch(in_shape, out_coords, kernel, stride,
                               padding, bitmap):
    """Window rulebook of a strided sparse conv, in INPUT rank space.
    out_coords: (B, O, 3) (any order); bitmap: the input resolution's. A
    deep grid's lookup gives the flat rulebook (conv_rulebook_batch)."""
    if not torch.is_tensor(bitmap):
        return conv_rulebook_batch(in_shape, out_coords, kernel, stride,
                                   padding, bitmap)
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    dy, dx = _tap_offsets_bev(k[1], k[2], out_coords.device)
    co = out_coords.long()
    qy = (co[..., 1] * s[1] - p[1])[..., None] + dy
    qx = (co[..., 2] * s[2] - p[2])[..., None] + dx
    z0 = (co[..., 0] * s[0] - p[0])[..., None]
    r0, pres = _bitmap_column_windows(bitmap, qy, qx, z0, k[0], in_shape)
    return r0, pres & (co[..., 0] >= 0)[..., None, None]


def _down_candidates(coords, kernel, stride, padding, oshape):
    """Per input voxel the candidate strided-conv outputs, per dim:
    o_i = floor((p + pad)/s) - i for i in [0, ceil(k/s)).

    coords: (B, V, 3). Returns broadcastable (oz (B, V, ncz, 1, 1),
    oy (B, V, 1, ncy, 1), ox (B, V, 1, 1, ncx), ok (B, V, ncz, ncy, ncx))."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    cand, valid = [], []
    for d in range(3):
        pd = coords[..., d].long()[..., None]               # (B, V, 1)
        i = torch.arange(-(-k[d] // s[d]), device=coords.device)
        o = (pd + p[d]) // s[d] - i                         # (B, V, ncand)
        j = pd + p[d] - o * s[d]                            # tap index
        valid.append((o >= 0) & (o < oshape[d]) & (pd >= 0)
                      & (j >= 0) & (j < k[d]))
        cand.append(o)
    oz = cand[0][..., :, None, None]
    oy = cand[1][..., None, :, None]
    ox = cand[2][..., None, None, :]
    ok = (valid[0][..., :, None, None] & valid[1][..., None, :, None]
          & valid[2][..., None, None, :])
    return oz, oy, ox, ok


def conv_out_coords(coords, shape, kernel, stride, padding, max_out: int):
    """The strided conv's output position set, batched: every output whose
    footprint covers an active input, deduplicated by a sort and head
    flags, compacted in ascending zyx-linear order. Under overflow the
    kept prefix is the lowest-z slab (z is the major digit), the
    reference's drop policy.

    coords: (B, V, 3). Returns (out_coords (B, max_out, 3) int32, -1
    padded; out_shape)."""
    oshape = out_spatial_shape(shape, kernel, stride, padding)
    oz, oy, ox, ok = _down_candidates(coords, kernel, stride, padding,
                                      oshape)
    lin = (oz * oshape[1] + oy) * oshape[2] + ox
    lin = torch.where(ok, lin, _SENTINEL).reshape(coords.shape[0], -1)
    slin = torch.sort(lin, dim=1).values
    head = slin != _SENTINEL
    head[:, 1:] &= slin[:, 1:] != slin[:, :-1]
    rank = row_cumsum(head.long()) - 1
    dest = torch.where(head & (rank < max_out), rank, max_out)
    out = torch.full((coords.shape[0], max_out + 1), _SENTINEL,
                     dtype=slin.dtype, device=slin.device)
    # every dropped candidate lands in the spare last column
    out.scatter_(1, dest, slin)
    return delinearize(out[:, :max_out], oshape), oshape


def stage_lookup_batch(coords, shape):
    """Reorder a resolution's rows into rank order and build its lookup:
    the bitmap for depths up to 64, else build_lookup_batch's dense or
    sorted table (any row order works there, this one too).

    Returns (order (B, V) int64, coords in rank order, lookup). Callers
    apply ``order`` to every per-row array."""
    order = yxz_order(coords, shape)
    co = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
    return order, co, rank_lookup(co, shape)


def rank_lookup(coords, shape):
    """The lookup of rows already in rank order: the bitmap for depths up
    to 64, else build_lookup_batch's table."""
    if shape[0] <= MAX_BITMAP_DEPTH:
        return build_bitmap_batch(coords, shape)
    return build_lookup_batch(coords, shape)


def pack_windows(r0, pres):
    """(r0 (..., K), pres (..., K, kz) bool) -> packed (..., K) int32.

    Canonical form: r0 is zeroed where no tap is present (no consumer
    reads it there), so device and host plans compare bit for bit."""
    r0 = torch.where(pres.any(-1), r0.long(), 0)
    packed = r0 & _PACK_MASK
    for j in range(pres.shape[-1]):
        packed = packed | (pres[..., j].long() << (_PACK_SHIFT + j))
    return packed.to(torch.int32)


# ---------------------------------------------------------------------------
# The strided conv's inverse rulebook (training)
# ---------------------------------------------------------------------------
# Packed inverse words (B, V, Kc) int32: bits 0..23 r0i, bits 24..24+ncz-1
# the z candidates' presence, bits 28..30 the (z, y, x) stride parities of
# the row, broadcast into every candidate column (read from column 0).

_PAR_SHIFT = 28


def strided_inverse_rulebook_batch(in_coords, kernel, stride, padding,
                                   out_bitmap, out_shape):
    """The inverse rulebook of a strided conv, in OUTPUT rank space.

    For input voxel q the outputs whose footprint covers it are o_d =
    obase_d - c_d with obase = (q + pad) // s and c_d in [0, ncand_d),
    through tap j_d = par_d + c_d s_d, par = (q + pad) mod s. With ncand_z
    <= 2 the z candidates are adjacent outputs, hence consecutive output
    ranks: one (ncand_z)-tap window per BEV candidate column (cy, cx).

    in_coords: (B, V, 3) the conv's input rows in rank order; out_bitmap:
    build_bitmap_batch of the output rows. Returns (r0i (B, V, Kc), presi
    (B, V, Kc, ncz), par (B, V, 3)), or None when ncand > 2 in any dim or
    the output resolution is a deep grid's (no bitmap). Port of
    det3d_tpu/ops/sparse.py::strided_inverse_rulebook_batch."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    nc = ncand_of(k, s)
    if max(nc) > 2 or not torch.is_tensor(out_bitmap):
        return None
    co = in_coords.long()
    # per dim with Python ints: a tensor made from (p, s) would be a copy
    # from host memory, which a captured step cannot replay
    t = [co[..., d] + p[d] for d in range(3)]
    par = torch.stack([t[d] % s[d] for d in range(3)], dim=-1)
    obase = torch.stack([t[d] // s[d] for d in range(3)], dim=-1)
    ci = torch.arange(nc[1] * nc[2], device=co.device)
    qy = obase[..., 1, None] - ci // nc[2]                # (B, V, Kc)
    qx = obase[..., 2, None] - ci % nc[2]
    z0 = (obase[..., 0] - (nc[0] - 1))[..., None]
    r0i, presi = _bitmap_column_windows(out_bitmap, qy, qx, z0, nc[0],
                                        out_shape)
    presi = presi & (co[..., 0] >= 0)[..., None, None]
    return r0i, presi, par


def pack_inverse(r0i, presi, par):
    """(r0i, presi, par) -> packed (B, V, Kc) int32 (canonical: r0i zeroed
    where no candidate is present)."""
    packed = pack_windows(r0i, presi).long()
    for d in range(3):
        packed = packed | ((par[..., d].long() & 1)
                           << (_PAR_SHIFT + d))[..., None]
    return packed.to(torch.int32)


def unpack_inverse(packed, ncz: int):
    """Packed inverse words -> (r0i (..., Kc) int64, presi (..., Kc, ncz)
    bool, par (..., 3) int64)."""
    r0i, presi = unpack_windows(packed, ncz)
    par = torch.stack([(packed[..., 0].long() >> (_PAR_SHIFT + d)) & 1
                       for d in range(3)], dim=-1)
    return r0i, presi, par


# ---------------------------------------------------------------------------
# Deep grids (depth > 64): dense and sorted lookups, flat rulebooks
# ---------------------------------------------------------------------------
# The bitmap keeps at most 64 z bits a column. A deeper grid looks each
# tap up in a slot table: a dense (D*H*W,) table of row ids while it holds
# at most _DENSE_TABLE_MAX_CELLS cells (one gather a query), else the
# sorted ids and a binary search. Its rulebooks are flat: per output row
# and tap (z-major (jz, jy, jx) order) the input row and its presence.

_DENSE_TABLE_MAX_CELLS = 256 * 1024 * 1024


class Flat(NamedTuple):
    """A flat per-tap rulebook of a deep resolution: idx (B, O, K) int64
    input rows (0 where absent), mask (B, O, K) bool."""
    idx: torch.Tensor
    mask: torch.Tensor


def build_dense_table(lin, n_cells: int):
    """(B, V) linear ids -> (B, n_cells) int32 tables of row ids, -1 where
    empty. One scatter for the batch at per-sample offsets; padding rows
    land in one spare slot that is dropped."""
    b, v = lin.shape
    keep = lin != _SENTINEL
    base = torch.arange(b, device=lin.device)[:, None] * n_cells
    flat = torch.where(keep, base + lin, b * n_cells)
    table = torch.full((b * n_cells + 1,), -1, dtype=torch.int32,
                       device=lin.device)
    rows = torch.arange(v, dtype=torch.int32, device=lin.device)
    table.scatter_(0, flat.reshape(-1), rows.expand(b, v).reshape(-1))
    return table[:-1].view(b, n_cells)


def lookup_dense(table, queries):
    """(B, n_cells) tables, (B, Q) linear ids -> (slot (B, Q) int64, found
    (B, Q) bool); sentinel queries are never found."""
    okq = queries != _SENTINEL
    slot = torch.gather(table, 1, torch.where(okq, queries, 0)).long()
    found = okq & (slot >= 0)
    return torch.where(found, slot, 0), found


def build_hash(lin):
    """(B, V) linear ids -> (sorted ids, perm): the sorted-table lookup."""
    return torch.sort(lin, dim=-1, stable=True)


def lookup(sorted_lin, perm, queries):
    """Binary search of (B, Q) queries in the sorted ids -> (slot (B, Q)
    int64 into the original rows, found (B, Q) bool)."""
    v = sorted_lin.shape[-1]
    pos = torch.searchsorted(sorted_lin, queries).clamp(max=v - 1)
    found = ((torch.gather(sorted_lin, 1, pos) == queries)
             & (queries != _SENTINEL))
    return torch.where(found, torch.gather(perm, 1, pos), 0), found


def build_lookup_batch(coords, shape):
    """(B, V, 3) zyx -> ("dense", tables) for grids of at most
    _DENSE_TABLE_MAX_CELLS cells, else ("sorted", (sorted ids, perm))."""
    n_cells = int(np.prod(shape))
    lin = linearize(coords, shape)
    if n_cells <= _DENSE_TABLE_MAX_CELLS:
        return ("dense", build_dense_table(lin, n_cells))
    return ("sorted", build_hash(lin))


def lookup_queries_batch(lookup_struct, qlin):
    """(B, Q) linear ids -> (slot (B, Q) int64, found (B, Q) bool)."""
    kind, data = lookup_struct
    if kind == "dense":
        return lookup_dense(data, qlin)
    return lookup(*data, qlin)


def _tap_offsets3(kernel, device):
    """(K,) jz, jy, jx of a kernel's taps in z-major order, from arange
    (no host copy)."""
    kz, ky, kx = _as3(kernel)
    t = torch.arange(kz * ky * kx, device=device)
    return t // (ky * kx), (t // kx) % ky, t % kx


def _flat_rulebook(q, valid_row, shape, lookup_struct):
    b, o, kvol, _ = q.shape
    idx, found = lookup_queries_batch(
        lookup_struct, linearize(q, shape).reshape(b, o * kvol))
    return (idx.view(b, o, kvol),
            found.view(b, o, kvol) & valid_row[..., None])


def _flat_from_windows(r0, pres):
    """The flat rulebook of window rulebook (r0, pres), absent taps at 0."""
    idx, mask = window_to_flat(r0, pres)
    return torch.where(mask, idx, 0), mask


def subm_rulebook_batch(coords, shape, kernel, lookup_struct):
    """Flat rulebook of a submanifold conv: per row and tap (z-major) the
    input row, over any lookup (a bitmap's through its windows). Returns
    (idx (B, V, K) int64, mask (B, V, K) bool)."""
    if torch.is_tensor(lookup_struct):
        return _flat_from_windows(*subm_window_rulebook_batch(
            coords, shape, kernel, lookup_struct))
    k = _as3(kernel)
    jz, jy, jx = _tap_offsets3(k, coords.device)
    co = coords.long()
    q = torch.stack([co[..., 0, None] + (jz - k[0] // 2),
                     co[..., 1, None] + (jy - k[1] // 2),
                     co[..., 2, None] + (jx - k[2] // 2)], dim=-1)
    return _flat_rulebook(q, co[..., 0] >= 0, shape, lookup_struct)


def conv_rulebook_batch(in_shape, out_coords, kernel, stride, padding,
                        lookup_struct):
    """Flat rulebook of a strided conv over the input resolution's lookup:
    tap j of output o reads input o * s - p + j. Returns (idx (B, O, K),
    mask (B, O, K))."""
    if torch.is_tensor(lookup_struct):
        return _flat_from_windows(*conv_window_rulebook_batch(
            in_shape, out_coords, kernel, stride, padding, lookup_struct))
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    jz, jy, jx = _tap_offsets3(k, out_coords.device)
    co = out_coords.long()
    q = torch.stack([(co[..., 0] * s[0] - p[0])[..., None] + jz,
                     (co[..., 1] * s[1] - p[1])[..., None] + jy,
                     (co[..., 2] * s[2] - p[2])[..., None] + jx], dim=-1)
    return _flat_rulebook(q, co[..., 0] >= 0, in_shape, lookup_struct)


def window_to_flat(r0, pres):
    """Window rulebook -> flat per-tap (idx, mask) in z-major tap order:
    rank(z0 + j) = r0 + popcount(pres[:j]). Absent taps keep that rank
    (possibly past the rows), which their False mask suppresses."""
    p = pres.long()
    idx = r0.long()[..., None] + p.cumsum(-1) - p       # (B, O, Kbev, kz)
    b, o = r0.shape[:2]
    return (idx.transpose(2, 3).reshape(b, o, -1),
            pres.transpose(2, 3).reshape(b, o, -1))


def center_column_taps(kernel=3):
    """The z-major tap ids of a cubic kernel's center BEV column."""
    k = _as3(kernel)[0]
    return tuple((jz * k + k // 2) * k + k // 2 for jz in range(3))


def flat_conv(features, idx, mask, weights, z_shift_taps=None):
    """Sparse conv over a flat rulebook, plain PyTorch (the JAX package's
    apply_conv flat branch, XLA code there).

    features (B, V, Cin); idx, mask (B, O, K); weights (K, Cin, Cout).
    ``z_shift_taps`` (k_minus, k_center, k_plus), submanifold rulebooks
    over rank-ordered rows (O == V): those taps read the previous row, the
    row itself and the next row, without a gather. Then one gather + GEMM
    per remaining tap, summed in fp32 (fp64 for fp64 operands). Autograd
    gives the backward (its gathers' scatter-adds)."""
    b, o = idx.shape[:2]
    cin = features.shape[-1]
    out = torch.zeros((b, o, weights.shape[-1]),
                      dtype=_acc_dtype(features.dtype),
                      device=features.device)
    shifted = {}
    if z_shift_taps is not None:
        assert o == features.shape[1]
        shifted = dict(zip(z_shift_taps, _center_taps(
            features, torch.ones((b, o, 3), dtype=torch.bool,
                                 device=features.device))))
    for k, g in shifted.items():
        out = out + _mm(g * mask[:, :, k, None].to(g.dtype), weights[k])
    for k in range(weights.shape[0]):
        if k in shifted:
            continue
        g = torch.gather(features, 1, idx[:, :, k, None].expand(-1, -1, cin))
        out = out + _mm(g * mask[:, :, k, None].to(g.dtype), weights[k])
    return out


def flat_conv_dx(dy, idx, mask, weights, v: int):
    """d(features) of a conv over flat rulebook (idx, mask): per tap,
    dY @ W[k]^T scatter-added into the rows the tap reads. dy (B, O,
    Cout); idx, mask (B, O, K), idx clamped into [0, V); weights (K, Cin,
    Cout). Returns (B, V, Cin) in fp32 (fp64 for fp64 operands). The dX
    of a strided window conv without an inverse rulebook, through
    window_to_flat (the JAX package's apply_conv_window VJP)."""
    b, o, kvol = idx.shape
    cin = weights.shape[1]
    dx = torch.zeros((b, v, cin), dtype=_acc_dtype(dy.dtype),
                     device=dy.device)
    if v == 0:
        return dx
    rows = idx.clamp(0, v - 1)
    for k in range(kvol):
        part = _mm(dy * mask[:, :, k, None].to(dy.dtype),
                   weights[k].transpose(0, 1))
        dx.scatter_add_(1, rows[:, :, k, None].expand(-1, -1, cin), part)
    return dx
