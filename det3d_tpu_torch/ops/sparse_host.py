"""Host-side builders of the sparse middle's packed rulebook plan.

Port of det3d_tpu/ops/sparse_host.py. Rulebooks are
pure functions of integer voxel coordinates, so a serving process builds
them on the CPU, beside its voxelizer, and the device step only reads
them. Every function is per sample; ``build_plan`` returns one sample's
plan and the caller stacks the batch.

The builders the serving path calls (``point_lin``, ``point_order``,
``voxel_coords``, ``subm_windows``, ``down_windows``, ``transition``,
``build_plan``) run the C++ twins of csrc/hostplan.cc, built with g++ at
first use (csrc/__init__.py); a failed build raises. The numpy versions
stay beside them as the plain versions, under the same names with a
``_ref`` suffix, and equal them array for array: the tests and
chip_smoke.py call them explicitly, nothing on the serving path does.

Packed window words (the layout of ops/sparse.py::unpack_windows): bits
0..23 hold r0, the rank of the window's first row, and bits 24..24+kz-1
the presence of the kz taps. Ranks number the active voxels in (y, x, z)
order. Where no tap is present r0 is 0. A training plan (``train=True``)
adds each strided conv's packed inverse rulebook (the layout of
ops/sparse.py::unpack_inverse): bits 0..23 r0i, bits 24.. the ncz
presence bits, bits 28..30 the (z, y, x) stride parities, broadcast into
every candidate column. The numpy versions need numpy >= 2.0
(``np.bitwise_count``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np

from det3d_tpu_torch import csrc

SENTINEL = np.iinfo(np.int32).max

_PACK_SHIFT = 24
_PACK_MASK = (1 << _PACK_SHIFT) - 1


def _as3(v) -> Tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v),) * 3
    t = tuple(int(x) for x in v)
    assert len(t) == 3
    return t


def out_spatial_shape(shape, kernel, stride, padding):
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    return tuple((shape[d] + 2 * p[d] - k[d]) // s[d] + 1 for d in range(3))


# ---------------------------------------------------------------------------
# The builders: C++ twins (csrc/hostplan.cc)
# ---------------------------------------------------------------------------

# hostplan.cc's point sorts pack a point's index into 22 bits
MAX_POINTS = 1 << 22


@functools.lru_cache(maxsize=None)
def _lib():
    """hostplan.cc's library, its functions' argument types declared."""
    lib = csrc.load("hostplan")
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.hp_point_lin.argtypes = [f32p, i64, i64, i64, f32p, f32p,
                                 i64, i64, i64, i32p]
    lib.hp_point_lin.restype = None
    lib.hp_point_order.argtypes = [i32p, i64, i64, i64, i64, i32, i32p]
    lib.hp_point_order.restype = None
    lib.hp_voxel_coords.argtypes = [i32p, i32p, i64, i64, i64, i64, i32p]
    lib.hp_voxel_coords.restype = None
    lib.hp_subm_windows.argtypes = [i32p, i64, i64, i64, i64,
                                    i64, i64, i64, i32p]
    lib.hp_subm_windows.restype = None
    lib.hp_down_windows.argtypes = [i32p, i64, i32p, i64, i64, i64, i64,
                                    i64p, i64p, i64p, i32p]
    lib.hp_down_windows.restype = None
    lib.hp_transition.argtypes = [i32p, i64, i64, i64, i64, i64p, i64p,
                                  i64p, i64, i32, i32p, i32p,
                                  ctypes.POINTER(i32)]
    lib.hp_transition.restype = i64
    lib.hp_voxelize_sorted.argtypes = [f32p, i64, i64, i32p, i32p, i64,
                                       i64, i64, i64, i32, f32p, i32p, i32p]
    lib.hp_voxelize_sorted.restype = i64
    lib.hp_voxelize_appearance.argtypes = [f32p, i64, i64, i32p, i32p, i64,
                                           i64, i64, i64, f32p, i32p, i32p]
    lib.hp_voxelize_appearance.restype = i64
    lib.hp_argsort_lin.argtypes = [i32p, i64, i32p]
    lib.hp_argsort_lin.restype = None
    return lib


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _c3(v):
    return np.ascontiguousarray(_as3(v), np.int64)


def _coords(coords, what):
    co = _i32(coords)
    if co.ndim != 2 or co.shape[1] != 3:
        raise ValueError(f"{what} must be (V, 3) zyx, got {co.shape}")
    return co


def _depth(shape):
    if not 0 < int(shape[0]) <= 64:
        raise ValueError(f"the per-column bitmap holds depths 1 to 64, got "
                         f"{shape[0]}")


def _lin(lin):
    lin = _i32(lin)
    if lin.ndim != 1 or lin.shape[0] >= MAX_POINTS:
        raise ValueError(f"voxel ids must be (P,) with P < {MAX_POINTS}, "
                         f"got {lin.shape}")
    return lin


def point_lin(points, num_points, voxel_size, pc_range, grid_size):
    """Quantize a padded cloud to xyz-major linear voxel ids (fp32 floor
    divide). Returns (P,) int32, SENTINEL for padding and out-of-range
    rows."""
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be (P, C >= 3), got {pts.shape}")
    gx, gy, gz = grid_size
    out = np.empty(pts.shape[0], np.int32)
    _lib().hp_point_lin(pts, pts.shape[0], pts.shape[1], int(num_points),
                        np.ascontiguousarray(pc_range[:3], np.float32),
                        np.ascontiguousarray(voxel_size, np.float32),
                        gx, gy, gz, out)
    return out


def point_order(lin, grid_size, order):
    """The voxelizer's point sort order: a stable lexsort by (key, lin),
    the key being the yxz rank key or the mix32 hash of the id."""
    if order not in ("yxz", "hashed"):
        raise ValueError(f"host plans need order 'hashed'/'yxz', got {order}")
    lin = _lin(lin)
    gx, gy, gz = grid_size
    out = np.empty(lin.shape[0], np.int32)
    _lib().hp_point_order(lin, lin.shape[0], gx, gy, gz,
                          1 if order == "yxz" else 0, out)
    return out


def argsort_lin(lin):
    """The stable argsort of the voxel ids (the appearance order's point
    permutation), (P,) int32."""
    lin = _lin(lin)
    out = np.empty(lin.shape[0], np.int32)
    _lib().hp_argsort_lin(lin, lin.shape[0], out)
    return out


def voxel_coords(lin, grid_size, max_voxels, order, perm=None):
    """Voxel coordinate rows of the sorted voxelizer orders ("hashed",
    "yxz"). Returns (max_voxels, 3) int32 zyx with -1 padding."""
    lin = _lin(lin)
    perm = (point_order(lin, grid_size, order) if perm is None
            else _i32(perm))
    if perm.shape != lin.shape:
        raise ValueError(f"perm {perm.shape} and lin {lin.shape} differ")
    gx, gy, _ = grid_size
    out = np.empty((int(max_voxels), 3), np.int32)
    _lib().hp_voxel_coords(lin, perm, lin.shape[0], gx, gy, int(max_voxels),
                           out)
    return out


def subm_windows(coords, shape, kernel=3):
    """Packed submanifold window rulebook; coords in rank order. Returns
    (V, ky*kx) int32 packed."""
    k = _as3(kernel)
    co = _coords(coords, "coords")
    _depth(shape)
    out = np.empty((co.shape[0], k[1] * k[2]), np.int32)
    _lib().hp_subm_windows(co, co.shape[0], shape[0], shape[1], shape[2],
                           k[0], k[1], k[2], out)
    return out


def down_windows(out_coords, in_coords, in_shape, kernel, stride, padding):
    """Packed strided-conv window rulebook in INPUT rank space.
    ``in_coords``: the input resolution's rows, in rank order."""
    k = _as3(kernel)
    oc = _coords(out_coords, "out_coords")
    ic = _coords(in_coords, "in_coords")
    _depth(in_shape)
    out = np.empty((oc.shape[0], k[1] * k[2]), np.int32)
    _lib().hp_down_windows(oc, oc.shape[0], ic, ic.shape[0], in_shape[0],
                           in_shape[1], in_shape[2], _c3(k), _c3(stride),
                           _c3(padding), out)
    return out


def _ncand(kernel, stride):
    k, s = _as3(kernel), _as3(stride)
    return tuple(-(-k[d] // s[d]) for d in range(3))


def transition(coords, shape, kernel, stride, padding, max_out,
               build_inverse=False):
    """Downsample transition: the output coords of a strided conv (every
    output whose footprint covers an active input), deduplicated, the
    low-z prefix in zyx cell order kept under the cap, rows emitted in yxz
    rank order. Returns (out_coords (max_out, 3) int32, oshape), and with
    ``build_inverse`` the conv's packed inverse rulebook (V, ncy*ncx) int32
    as a third item where ncand <= 2 in every dim."""
    co = _coords(coords, "coords")
    oshape = out_spatial_shape(shape, kernel, stride, padding)
    nc = _ncand(kernel, stride)
    want = bool(build_inverse) and max(nc) <= 2
    out = np.empty((int(max_out), 3), np.int32)
    inv = np.empty((co.shape[0], nc[1] * nc[2]) if want else (1, 1),
                   np.int32)
    built = ctypes.c_int32(0)
    _lib().hp_transition(co, co.shape[0], shape[0], shape[1], shape[2],
                         _c3(kernel), _c3(stride), _c3(padding),
                         int(max_out), int(want), out, inv,
                         ctypes.byref(built))
    if want != bool(built.value):
        raise RuntimeError("hp_transition built the inverse rulebook "
                           f"{bool(built.value)}, asked {want}")
    return (out, oshape, inv) if want else (out, oshape)


def build_plan(points, num_points, *, voxel_size, pc_range, grid_size,
               max_voxels, order, spec, train=False) -> Dict[str, np.ndarray]:
    """Host plan of one sample: point voxel ids and every rulebook the
    sparse middle reads, packed.

    ``spec`` comes from models/backbones.py::middle_plan_spec. Keys:
      point_lin, point_perm (P,) int32 — voxel ids and sort order
      plan_order0      (V,)  int32 — only when the middle is not pre_ranked
      plan_s0          (V, 9) packed subm windows at res0
      plan_co{i}       (cap_i,) int32 zyx-linear stage coords
      plan_down{i}     (cap_i, Kbev) packed down-conv windows
      plan_subm{i}     (cap_i, 9) packed subm windows (stages that keep one)
      plan_inv{i}      (V_{i-1}, Kc) packed inverse rulebooks (train only)
    """
    lin = point_lin(points, num_points, voxel_size, pc_range, grid_size)
    perm = point_order(lin, grid_size, order)
    coords = voxel_coords(lin, grid_size, max_voxels, order, perm=perm)
    out: Dict[str, np.ndarray] = {"point_lin": lin, "point_perm": perm}

    shape0 = tuple(spec["shape0"])
    if spec["pre_ranked"]:
        co = coords
    else:
        order0 = rank_order(coords, shape0)
        co = coords[order0]
        out["plan_order0"] = order0
    out["plan_s0"] = subm_windows(co, shape0, 3)

    shape = shape0
    for i, st in enumerate(spec["stages"], start=1):
        k, s, p, cap = st["kernel"], st["stride"], st["padding"], st["cap"]
        res = transition(co, shape, k, s, p, cap, build_inverse=train)
        out_co, oshape = res[:2]
        if len(res) > 2:
            out[f"plan_inv{i}"] = res[2]
        out[f"plan_down{i}"] = down_windows(out_co, co, shape, k, s, p)
        out[f"plan_co{i}"] = linearize(out_co, oshape)
        if st["subm"]:
            out[f"plan_subm{i}"] = subm_windows(out_co, oshape, 3)
        co, shape = out_co, oshape
    return out


# ---------------------------------------------------------------------------
# Plain versions (numpy): voxel ids and coordinates
# ---------------------------------------------------------------------------


def point_lin_ref(points, num_points, voxel_size, pc_range, grid_size):
    """Quantize a padded cloud to xyz-major linear voxel ids (fp32 floor
    divide). Returns (P,) int32, SENTINEL for padding and out-of-range
    rows."""
    pts = np.asarray(points, np.float32)
    P = pts.shape[0]
    gx, gy, gz = grid_size
    vmin = np.asarray(pc_range[:3], np.float32)
    vs = np.asarray(voxel_size, np.float32)
    c = np.floor((pts[:, :3] - vmin) / vs).astype(np.int64)
    ok = (np.arange(P) < int(num_points))
    ok &= (c[:, 0] >= 0) & (c[:, 0] < gx)
    ok &= (c[:, 1] >= 0) & (c[:, 1] < gy)
    ok &= (c[:, 2] >= 0) & (c[:, 2] < gz)
    lin = c[:, 0] + c[:, 1] * gx + c[:, 2] * (gx * gy)
    return np.where(ok, lin, SENTINEL).astype(np.int32)


def _mix32(x):
    """Murmur3 finalizer on uint32."""
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def point_order_ref(lin, grid_size, order):
    """The voxelizer's point sort order: a stable lexsort by (key, lin),
    the key being the yxz rank key or the mix32 hash of the id."""
    gx, gy, gz = grid_size
    lin = np.asarray(lin, np.int64)
    if order == "yxz":
        xx = lin % gx
        yy = (lin // gx) % gy
        zz = lin // (gx * gy)
        key = np.where(lin == SENTINEL, np.int64(SENTINEL),
                       (yy * gx + xx) * gz + zz)
    elif order == "hashed":
        key = np.where(lin == SENTINEL, np.int64(0xFFFFFFFF),
                       _mix32(lin.astype(np.uint32)).astype(np.int64))
    else:
        raise ValueError(f"host plans need order 'hashed'/'yxz', got {order}")
    return np.lexsort((lin, key)).astype(np.int32)


def voxel_coords_ref(lin, grid_size, max_voxels, order, perm=None):
    """Voxel coordinate rows of the sorted voxelizer orders ("hashed",
    "yxz"). Returns (max_voxels, 3) int32 zyx with -1 padding."""
    gx, gy, gz = grid_size
    if perm is None:
        perm = point_order_ref(lin, grid_size, order)
    lin = np.asarray(lin, np.int64)
    slin = lin[perm]
    svalid = slin != SENTINEL
    head = svalid.copy()
    head[1:] &= slin[1:] != slin[:-1]
    seg_id = np.cumsum(head) - 1
    keep = head & (seg_id < max_voxels)
    kept = slin[keep]
    out = np.full((max_voxels, 3), -1, np.int32)
    n = kept.shape[0]
    out[:n, 0] = kept // (gx * gy)
    out[:n, 1] = (kept // gx) % gy
    out[:n, 2] = kept % gx
    return out


# ---------------------------------------------------------------------------
# Rank keys (both builders); the plain versions' bitmap and rulebooks
# ---------------------------------------------------------------------------


def yxz_keys(coords, shape):
    """(V, 3) zyx -> yxz-major rank keys; invalid rows -> SENTINEL. Rows in
    rank order give an ascending array with the sentinels last."""
    d, h, w = shape
    co = np.asarray(coords, np.int64)
    z, y, x = co[:, 0], co[:, 1], co[:, 2]
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return np.where(ok, (y * w + x) * d + z, np.int64(SENTINEL))


def rank_order(coords, shape):
    """Row permutation putting coords in rank order (stable argsort)."""
    return np.argsort(yxz_keys(coords, shape), kind="stable").astype(np.int32)


def _pack_windows(r0, pres):
    # canonical form: r0 zeroed where no tap is present
    r0 = np.where(pres.any(-1), r0, 0)
    packed = (np.asarray(r0, np.int64) & _PACK_MASK).astype(np.int32)
    for j in range(pres.shape[-1]):
        packed = packed | (pres[..., j].astype(np.int32)
                           << (_PACK_SHIFT + j))
    return packed


def host_bitmap(keys, shape):
    """Dense per-column (base, bits) lookup from SORTED yxz rank keys:
    base (h*w,) int32 is the exclusive rank base of each BEV column, bits
    (h*w,) uint64 its z-occupancy word."""
    d, h, w = shape
    k = keys[keys != SENTINEL]
    col = (k // d).astype(np.int64)
    z = (k % d).astype(np.uint64)
    bits = np.zeros(h * w, np.uint64)
    counts = np.zeros(h * w, np.int64)
    if k.size:
        head = np.ones(k.shape[0], bool)
        head[1:] = col[1:] != col[:-1]
        starts = np.flatnonzero(head)
        occ = col[starts]
        bits[occ] = np.bitwise_or.reduceat(np.uint64(1) << z, starts)
        counts[occ] = np.diff(np.append(starts, k.shape[0]))
    base = (np.cumsum(counts) - counts).astype(np.int32)
    return base, bits


def _column_windows(lookup, qy, qx, z0, kz, shape):
    """Per-column window base rank and tap presence over a host bitmap:
    r0 = base + popcount of the bits below clip(z0, 0, d-1); presence =
    in bounds and bit set. Returns (r0 (..., K), pres (..., K, kz))."""
    d, h, w = shape
    base_t, bits_t = lookup
    okc = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
    flat = np.where(okc, qy * w + qx, 0)
    word = bits_t[flat]
    z0b = np.broadcast_to(z0, okc.shape)
    zc = np.clip(z0b, 0, d - 1).astype(np.uint64)
    below = np.bitwise_count(word & ((np.uint64(1) << zc) - np.uint64(1)))
    r0 = np.where(okc, base_t[flat].astype(np.int64) + below.astype(np.int64),
                  0)
    pres = []
    for j in range(kz):
        zj = z0b + j
        okz = okc & (zj >= 0) & (zj < d)
        zjc = np.where(okz, zj, 0).astype(np.uint64)
        pres.append(okz & (((word >> zjc) & np.uint64(1)) != 0))
    return r0.astype(np.int32), np.stack(pres, axis=-1)


def subm_windows_ref(coords, shape, kernel=3, lookup=None):
    """Packed submanifold window rulebook; coords in rank order. Returns
    (V, ky*kx) int32 packed."""
    k = _as3(kernel)
    pad = tuple(kk // 2 for kk in k)
    if lookup is None:
        lookup = host_bitmap(yxz_keys(coords, shape), shape)
    dy = np.repeat(np.arange(k[1]) - pad[1], k[2])
    dx = np.tile(np.arange(k[2]) - pad[2], k[1])
    co = np.asarray(coords, np.int64)
    qy = co[:, 1, None] + dy[None]
    qx = co[:, 2, None] + dx[None]
    z0 = co[:, 0, None] - pad[0]
    r0, pres = _column_windows(lookup, qy, qx, z0, k[0], shape)
    pres &= (co[:, 0] >= 0)[:, None, None]
    return _pack_windows(r0, pres)


def down_windows_ref(out_coords, in_lookup, in_shape, kernel, stride,
                     padding):
    """Packed strided-conv window rulebook in INPUT rank space.
    ``in_lookup`` is the input resolution's host_bitmap."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    oc = np.asarray(out_coords, np.int64)
    scaled = oc * np.asarray(s, np.int64)[None]
    dy = np.repeat(np.arange(k[1]), k[2])
    dx = np.tile(np.arange(k[2]), k[1])
    qy = scaled[:, 1, None] + dy[None] - p[1]
    qx = scaled[:, 2, None] + dx[None] - p[2]
    z0 = scaled[:, 0, None] - p[0]
    r0, pres = _column_windows(in_lookup, qy, qx, z0, k[0], in_shape)
    pres &= (oc[:, 0] >= 0)[:, None, None]
    return _pack_windows(r0, pres)


def _down_candidates(coords, shape, k, s, p, oshape):
    """The at most ceil(k/s) output candidates per dim of each input row:
    (oz, oy, ox) broadcastable, ``ok`` where the candidate is in bounds
    and its tap in the kernel, and per dim the in-bounds masks alone."""
    co = np.asarray(coords, np.int64)
    cand, bounds, valid = [], [], []
    ncand = tuple(-(-k[d] // s[d]) for d in range(3))
    for d in range(3):
        pd = co[:, d]
        base = np.floor_divide(pd + p[d], s[d])
        i = np.arange(ncand[d], dtype=np.int64)
        o = base[:, None] - i[None]
        j = pd[:, None] + p[d] - o * s[d]
        okb = (o >= 0) & (o < oshape[d]) & (pd >= 0)[:, None]
        cand.append(o)
        bounds.append(okb)
        valid.append(okb & (j >= 0) & (j < k[d]))
    oz = cand[0][:, :, None, None]
    oy = cand[1][:, None, :, None]
    ox = cand[2][:, None, None, :]
    ok = (valid[0][:, :, None, None] & valid[1][:, None, :, None]
          & valid[2][:, None, None, :])
    okb = (bounds[0][:, :, None, None], bounds[1][:, None, :, None],
           bounds[2][:, None, None, :])
    return oz, oy, ox, ok, okb


def transition_ref(coords, shape, kernel, stride, padding, max_out,
                   build_inverse=False):
    """``transition`` in numpy: the same output coords and, with
    ``build_inverse`` (ncand <= 2), the same packed inverse rulebook."""
    k, s, p = _as3(kernel), _as3(stride), _as3(padding)
    oshape = out_spatial_shape(shape, k, s, p)
    do, ho, wo = oshape
    oz, oy, ox, ok, okb = _down_candidates(coords, shape, k, s, p, oshape)
    full = ok.shape
    lin = np.broadcast_to((oz * ho + oy) * wo + ox, full)
    occ = np.unique(lin[ok])            # zyx-major ascending
    kept_zyx = occ[:max_out]
    kz_, ky_, kx_ = (kept_zyx // (ho * wo), (kept_zyx // wo) % ho,
                     kept_zyx % wo)
    yxz = (ky_ * wo + kx_) * do + kz_
    order = np.argsort(yxz, kind="stable")
    out = np.full((max_out, 3), -1, np.int32)
    n = kept_zyx.shape[0]
    out[:n, 0] = kz_[order]
    out[:n, 1] = ky_[order]
    out[:n, 2] = kx_[order]
    nc = _ncand(k, s)
    if not build_inverse or max(nc) > 2:
        return out, oshape
    # the inverse rulebook from the same candidates: rank and presence
    # against the kept output set, through its bitmap
    base_t, bits_t = host_bitmap(np.sort(yxz), oshape)
    okb_yx = np.broadcast_to(okb[1] & okb[2], full)
    okbf = okb_yx & np.broadcast_to(okb[0], full)
    col = np.where(okb_yx, np.broadcast_to(oy * wo + ox, full), 0)
    word = bits_t[col]
    zc = np.clip(np.broadcast_to(oz, full), 0, 31).astype(np.uint64)
    rank = (base_t[col].astype(np.int64) + np.bitwise_count(
        word & ((np.uint64(1) << zc) - np.uint64(1)))).astype(np.int32)
    ozb = np.broadcast_to(oz, full)
    inz = (ozb >= 0) & (ozb < do)
    zq = np.where(inz, ozb, 0).astype(np.uint64)
    kept_c = okbf & inz & (((word >> zq) & np.uint64(1)) != 0)
    v = np.asarray(coords).shape[0]
    ncz, ncy, ncx = nc
    r0i = rank.reshape(v, ncz, ncy * ncx)[:, ncz - 1]
    # candidate axis c_z descends in z; window tap m = ncz-1-c_z ascends
    presi = kept_c.reshape(v, ncz, ncy * ncx).transpose(0, 2, 1)[:, :, ::-1]
    co = np.asarray(coords, np.int64)
    presi = presi & (co[:, 0] >= 0)[:, None, None]
    par = (co + np.asarray(p, np.int64)[None]) % np.asarray(s, np.int64)[None]
    packed = _pack_windows(r0i, presi)
    for d in range(3):
        packed = packed | ((par[:, d] & 1) << (28 + d)).astype(
            np.int32)[:, None]
    return out, oshape, packed


def linearize(coords, shape):
    """zyx-major linear ids, SENTINEL for padding rows."""
    d, h, w = shape
    co = np.asarray(coords, np.int64)
    z, y, x = co[:, 0], co[:, 1], co[:, 2]
    ok = (z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    return np.where(ok, (z * h + y) * w + x, SENTINEL).astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions: whole-middle plans
# ---------------------------------------------------------------------------


def build_plan_ref(points, num_points, *, voxel_size, pc_range, grid_size,
                   max_voxels, order, spec,
                   train=False) -> Dict[str, np.ndarray]:
    """``build_plan`` in numpy: the same plan, array for array."""
    lin = point_lin_ref(points, num_points, voxel_size, pc_range, grid_size)
    perm = point_order_ref(lin, grid_size, order)
    coords = voxel_coords_ref(lin, grid_size, max_voxels, order, perm=perm)
    out: Dict[str, np.ndarray] = {"point_lin": lin, "point_perm": perm}

    shape0 = tuple(spec["shape0"])
    if spec["pre_ranked"]:
        co = coords
    else:
        order0 = rank_order(coords, shape0)
        co = coords[order0]
        out["plan_order0"] = order0
    lk = host_bitmap(yxz_keys(co, shape0), shape0)
    out["plan_s0"] = subm_windows_ref(co, shape0, 3, lookup=lk)

    shape = shape0
    for i, st in enumerate(spec["stages"], start=1):
        k, s, p, cap = st["kernel"], st["stride"], st["padding"], st["cap"]
        res = transition_ref(co, shape, k, s, p, cap, build_inverse=train)
        out_co, oshape = res[:2]
        if len(res) > 2:
            out[f"plan_inv{i}"] = res[2]
        out[f"plan_down{i}"] = down_windows_ref(out_co, lk, shape, k, s, p)
        out[f"plan_co{i}"] = linearize(out_co, oshape)
        lk = host_bitmap(yxz_keys(out_co, oshape), oshape)
        if st["subm"]:
            out[f"plan_subm{i}"] = subm_windows_ref(out_co, oshape, 3,
                                                    lookup=lk)
        co, shape = out_co, oshape
    return out
