"""Sparse window convolution: the CUDA kernels' wrappers, their plain
twins, and the autograd Function over them.

``window_conv`` replaces det3d_tpu/ops/band_conv.py::band_window_conv (the
Pallas TPU kernel) and, with it, the contract of
det3d_tpu/ops/sparse.py::apply_conv_window and apply_conv_window_inv,
their custom VJPs included. Its forward: a CUDA tensor launches the
hand-written kernel in ``csrc/window_conv.cu``; a CPU tensor takes
``window_conv_ref`` (ops/sparse.py), the same function in plain PyTorch.
Its backward (fp32 on the card; the JAX package's is XLA code):

- dX of a submanifold conv (``center_shift``): ``window_conv_subm_dx``,
  the forward kernel over dY with the same words and the weights
  mirrored and transposed (the rulebook is its own transpose);
- dX of a strided conv: ``window_conv_inv``, the kernels
  ``window_conv_inv_count_kernel`` and ``window_conv_inv_kernel`` of
  ``csrc/window_conv_bwd.cu`` over the conv's inverse rulebook, its rows
  grouped by stride-parity class on the card (twin
  ``ops/sparse.py::window_conv_inv_ref``);
  a strided conv without one (more than 2 output candidates a dim, or a
  plan built for serving) takes the flat per-tap backward,
  ``ops/sparse.py::window_to_flat`` and ``flat_conv_dx`` (a scatter-add
  over the taps in plain PyTorch, as the JAX package's VJP is XLA code);
- dW of both: ``window_conv_dw``, the kernels ``window_conv_dw_kernel``
  and ``window_conv_dw_sum_kernel`` of ``csrc/window_conv_bwd.cu`` (a
  block per chunk of rows and tap, partial sums, then a sum in a fixed
  order: no atomics, the same bits every call; twin
  ``ops/sparse.py::window_conv_dw_ref``).
  Both backward kernels run on the fp32 CUDA cores, and their schedules
  are functions of the shapes alone; the CPU models below (dw_chunks,
  dw_grid, dw_geometry, inv_geometry, inverse_classes, inverse_blocks)
  are held to the kernels on the card and to JAX's plans on the CPU.

dX is computed only where the features need a gradient (not the stem's
VFE means). Each wrapper counts its launches (``.launches``); CPU
tensors take the twins, CUDA tensors launch the kernels or raise.
bf16 operands run on the tensor cores (mma.sync over rows gathered by
cp.async), fp32 operands on the fp32 CUDA cores (register-blocked FMAs over
rows gathered by cp.async, each warp skipping the taps its band of rows
does not read; ``f32_schedule`` models that schedule on the CPU); the
operands' type alone picks the kernel. Both take Cout 16, 32, 64 or 128,
Cin up to 128, kz up to 7, and weights on a 16-byte boundary. There is no
fallback between any of them.

The kernel reads the packed plan words (r0 | pres << 24) directly; the
band machinery of the TPU kernel (band_prep, plan_band, the serve_*band
buckets) has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch import csrc
from det3d_tpu_torch.utils import flops
from det3d_tpu_torch.ops.sparse import (_PACK_MASK, _PACK_SHIFT,
                                        flat_conv_dx, ncand_of,
                                        unpack_inverse, unpack_windows,
                                        window_conv_dw_ref,
                                        window_conv_inv_ref, window_conv_ref,
                                        window_to_flat)

__all__ = ["window_conv", "window_conv_ref", "window_conv_subm_dx",
           "window_conv_dw", "window_conv_inv", "f32_schedule"]

_COUTS = (16, 32, 64, 128)
_MAX_CIN = 128
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = csrc.load("window_conv")
    fn = lib.window_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.window_conv_smem.argtypes = [ctypes.c_int] * 5
    lib.window_conv_smem.restype = ctypes.c_longlong
    lib.window_conv_blocks_per_sm.argtypes = [ctypes.c_int] * 5
    lib.window_conv_blocks_per_sm.restype = ctypes.c_int
    lib.window_conv_geometry.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.window_conv_geometry.restype = ctypes.c_int
    return lib


def kernel_geometry(cout):
    """The fp32 kernel's own constants at ``cout``: (tile rows, warps, band
    rows, stages, a thread's rows, a thread's channels, lanes splitting the
    input channels). Builds the kernel."""
    g = (ctypes.c_int * 7)()
    if _lib().window_conv_geometry(cout, ctypes.addressof(g)) != 0:
        raise ValueError(f"no fp32 window-conv kernel for Cout={cout}")
    return tuple(g)


def blocks_per_sm(cin, cout, k, kz, bf16):
    """Blocks of the kernel for these operands that one SM of the current
    card holds at once (registers, threads and shared memory)."""
    return _lib().window_conv_blocks_per_sm(cin, cout, k, kz, int(bf16))


@functools.lru_cache(maxsize=None)
def _smem(index, cin, cout, k, kz, bf16):
    """(bytes of shared memory a block of the kernel needs, bytes the card
    ``index`` allows a block)."""
    need = _lib().window_conv_smem(cin, cout, k, kz, int(bf16))
    have = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    return need, have


def _check(features, packed, weights, center_shift):
    dev = features.device
    if dev.type != "cuda":
        raise ValueError(f"window_conv: no kernel for device {dev}")
    if features.dim() != 3 or packed.dim() != 3 or weights.dim() != 3:
        raise ValueError(
            f"features (B, V, Cin), packed (B, O, K) and weights "
            f"(kz*K, Cin, Cout) expected, got {tuple(features.shape)}, "
            f"{tuple(packed.shape)}, {tuple(weights.shape)}")
    b, v, cin = features.shape
    bo, o, k = packed.shape
    kvol, wcin, cout = weights.shape
    if bo != b or wcin != cin or kvol % k:
        raise ValueError(f"shapes disagree: features {tuple(features.shape)}"
                         f", packed {tuple(packed.shape)}, weights "
                         f"{tuple(weights.shape)}")
    kz = kvol // k
    for name, t in (("packed", packed), ("weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, features on {dev}")
    if features.dtype not in _DTYPES or weights.dtype != features.dtype:
        raise ValueError(f"features and weights must share fp32 or bf16, "
                         f"got {features.dtype} and {weights.dtype}")
    if packed.dtype != torch.int32:
        raise ValueError(f"packed must be int32, got {packed.dtype}")
    for name, t in (("features", features), ("packed", packed),
                    ("weights", weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cout not in _COUTS or not 0 < cin <= _MAX_CIN or not 0 < kz <= 7:
        raise ValueError(f"window_conv kernel takes Cout in {_COUTS}, "
                         f"0 < Cin <= {_MAX_CIN} and 0 < kz <= 7; got "
                         f"Cout={cout}, Cin={cin}, kz={kz}")
    if v > _PACK_MASK + 1:
        raise ValueError(f"V={v} exceeds the packed rank range")
    if center_shift and (kz != 3 or o != v):
        raise ValueError("center_shift needs kz=3 and O == V")
    bf16 = features.dtype == torch.bfloat16
    if weights.data_ptr() % 16:
        raise ValueError("weights must start on a 16-byte boundary")
    need, have = _smem(dev.index, cin, cout, k, kz, bf16)
    if need > have:
        raise ValueError(f"window_conv: a window of K={k} columns x kz={kz} "
                         f"at Cin={cin}, Cout={cout} needs {need} bytes of "
                         f"shared memory a block, the card allows {have}")
    return b, v, o, k, kz, cin, cout


# The fp32 kernel's geometry: {Cout: (tile rows, band rows)}. A block owns
# a tile of output rows; its warp w multiplies the band [w * band,
# (w + 1) * band) of them and skips a listed tap that no row of its band
# reads. A cuda test holds these equal to the kernel's own constants
# (window_conv_geometry).
F32_GEOMETRY = {16: (64, 16), 32: (64, 16), 64: (32, 8), 128: (64, 8)}


def f32_schedule(packed, v: int, center_shift: bool, cout: int, kz: int = 3):
    """The fp32 kernel's tile schedule on a rulebook, in plain PyTorch.

    packed: (B, O, K) int32 words r0 | pres << 24 over ``v`` input rows.
    A tile lists tap (k, j) where any of its rows has presence bit j in
    column k (rows past O have none). A warp runs a listed tap where any
    row of its band reads an input row for it: the bit is present and the
    row, min(r0, V-1) + popcount(pres[:j]) (the center column of a
    submanifold rulebook: o + j - 1), lies in [0, V).

    Returns a dict: ``listed`` (B, T, K, kz) and ``runs`` (B, T, warps, K,
    kz) bool over T tiles; ``tile`` and ``band`` rows; ``useful``, the
    (o, k, j) that read a row; ``executed``, the rows the warps multiply
    (``band`` for each tap a warp runs). executed / useful is the ratio of
    the products the kernel runs to those the conv needs."""
    tile, band = F32_GEOMETRY[cout]
    b, o, k = packed.shape
    t = -(-o // tile)
    words = torch.zeros(b, t * tile, k, dtype=torch.int64)
    words[:, :o] = packed.long().cpu()
    pres = torch.stack([(words >> (_PACK_SHIFT + j)) & 1 for j in range(kz)],
                       -1).bool()
    r0 = torch.clamp(words & _PACK_MASK, max=max(v - 1, 0))
    rows = r0[..., None] + pres.long().cumsum(-1) - pres.long()
    if center_shift:
        rows[:, :, k // 2] = (torch.arange(t * tile)[:, None] - 1
                              + torch.arange(kz))
    reads = pres & (rows >= 0) & (rows < v)
    listed = pres.view(b, t, tile, k, kz).any(2)
    runs = reads.view(b, t, tile // band, band, k, kz).any(3)
    return dict(listed=listed, runs=runs, tile=tile, band=band,
                useful=int(reads.sum()), executed=int(runs.sum()) * band)


def _forward(features, packed, weights, center_shift):
    """The forward function: the plain version on the CPU, else the
    kernel. Returns (out, launched). Counted by utils/flops.py's
    conv_work rule."""
    with flops.kernel("window_conv", features, packed, weights,
                      center_shift):
        return _forward_call(features, packed, weights, center_shift)


def _forward_call(features, packed, weights, center_shift):
    if features.device.type == "cpu":
        kz = weights.shape[0] // packed.shape[-1]
        r0, pres = unpack_windows(packed, kz)
        return window_conv_ref(features, r0, pres, weights,
                               center_shift), False
    b, v, o, k, kz, cin, cout = _check(features, packed, weights,
                                       center_shift)
    out = torch.empty((b, o, cout), dtype=torch.float32,
                      device=features.device)
    if b == 0 or o == 0:
        return out, False
    if v == 0:
        return out.zero_(), False
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().window_conv_launch(
            features.data_ptr(), packed.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, v, o, k, kz, cin, cout, int(bool(center_shift)),
            int(features.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"window_conv: CUDA launch failed (cudaError "
                           f"{err})")
    return out, True


def window_conv(features, packed, weights, center_shift: bool,
                inverse=None):
    """Sparse conv over a packed window rulebook, differentiable.

    features: (B, V, Cin) fp32 or bf16; packed: (B, O, K) int32 words
    r0 | pres << 24; weights: (kz*K, Cin, Cout) z-major, the features'
    type. ``center_shift``: submanifold rulebook (O == V, kz == 3), whose
    center BEV column reads rows o-1, o, o+1. ``inverse``: a strided
    conv's (packed inverse rulebook (B, V, Kc) int32, kernel, stride),
    which its backward's dX reads; without one a strided conv's dX is the
    flat per-tap scatter-add (flat_conv_dx). Returns (B, O, Cout) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    the tensor-core one for bf16 and the CUDA-core one for fp32 (one
    launch, counted in ``window_conv.launches``); any other input raises,
    as do weights off a 16-byte boundary. The backward runs
    window_conv_subm_dx or window_conv_inv, and window_conv_dw.
    """
    return _WindowConv.apply(features, packed, weights, bool(center_shift),
                             inverse)


window_conv.launches = 0


class _WindowConv(torch.autograd.Function):
    """window_conv's forward and backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, features, packed, weights, center_shift, inverse):
        out, launched = _forward(features, packed, weights, center_shift)
        if launched:
            window_conv.launches += 1
        ctx.center_shift = center_shift
        ctx.geometry = None if inverse is None else inverse[1:]
        ctx.save_for_backward(features, packed, weights,
                              None if inverse is None else inverse[0])
        return out

    @staticmethod
    def backward(ctx, dy):
        features, packed, weights, inv = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.center_shift:
                dx = window_conv_subm_dx(dy, packed, weights)
            elif inv is None:
                kz = weights.shape[0] // packed.shape[-1]
                idx, mask = window_to_flat(*unpack_windows(packed, kz))
                dx = flat_conv_dx(dy, idx, mask, weights.to(dy.dtype),
                                  features.shape[1])
            else:
                dx = window_conv_inv(dy, inv, weights, *ctx.geometry,
                                     features.shape[1])
            dx = dx.to(features.dtype)
        if ctx.needs_input_grad[2]:
            dw = window_conv_dw(features, packed, dy, ctx.center_shift,
                                weights.shape[0] // packed.shape[-1]
                                ).to(weights.dtype)
        return dx, None, dw, None, None


def window_conv_subm_dx(dy, packed, weights):
    """dX of a submanifold window conv: the forward over ``dy`` (B, V,
    Cout) with the same packed words and the weights mirrored and
    transposed, W'[m] = W[kvol-1-m]^T: tap m of row o reads row i exactly
    when tap kvol-1-m of row i reads row o, with equal presence, and the
    mirror maps the center column onto itself. Returns (B, V, Cin) fp32.
    On the card the forward kernel's launch is counted here
    (``window_conv_subm_dx.launches``), not in ``window_conv.launches``.
    Port of det3d_tpu/ops/sparse.py::_window_conv_bwd_fused (dX)."""
    wt = weights.flip(0).transpose(1, 2).to(dy.dtype).contiguous()
    out, launched = _forward(dy, packed, wt, True)
    if launched:
        window_conv_subm_dx.launches += 1
    return out


window_conv_subm_dx.launches = 0


# ---------------------------------------------------------------------------
# The backward kernels (csrc/window_conv_bwd.cu)
# ---------------------------------------------------------------------------
# The kernels' schedules are functions of the shapes alone. Their CPU
# models below (dw_chunks, dw_chunk_rows, dw_grid, dw_geometry,
# inv_geometry, inverse_classes, inverse_blocks) are what the tests hold
# to the kernels' own (window_conv_dw_geometry, window_conv_inv_geometry)
# and to the JAX package's training plans.

# dW's first pass: 256-row tiles, walked in segments of 8 by a block of
# 256 threads that owns a chunk of them and one tap; about DW_BLOCKS
# blocks a launch (chunks x taps)
DW_TILE = 256
DW_SEG_TILES = 8
DW_BLOCKS = 864
DW_MIN_PAIRS = 64                       # pairs a ring stage, at least
DW_STAGES = 3                           # its cp.async ring depth
DW_CENTER_SPLIT = 4                     # a subm conv's center tap: 4C chunks
# the inverse dX: 1024-row count tiles, at most 256 rows a block
INV_COUNT_ROWS = 1024
INV_MAX_ROWS = 256
INV_MAX_TAPS = 8
_THREADS = 256
_MAX_SMEM = 232448              # bytes a block may use on the H100
_TWO_BLOCKS = 113 * 1024        # at most this a block for two an SM


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = csrc.load("window_conv_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_conv_dw_launch.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.window_conv_dw_launch.restype = i
    lib.window_conv_inv_launch.argtypes = [p] * 6 + [i] * 12 + [p]
    lib.window_conv_inv_launch.restype = i
    lib.window_conv_dw_geometry.argtypes = [i] * 9 + [p]
    lib.window_conv_dw_geometry.restype = i
    lib.window_conv_dw_rows.argtypes = [i, i, i, p]
    lib.window_conv_dw_rows.restype = i
    lib.window_conv_inv_geometry.argtypes = [i, i, p]
    lib.window_conv_inv_geometry.restype = i
    return lib


def dw_chunks(rows: int, kvol: int) -> int:
    """Chunks C of dW's first pass over ``rows`` = B*O output rows: about
    DW_BLOCKS blocks (C x kvol), at most one chunk a 256-row tile. A
    function of the shapes alone, so every call sums in the same order."""
    tiles = max(1, -(-rows // DW_TILE))
    return min(tiles, -(-DW_BLOCKS // kvol))


def dw_chunk_rows(rows: int, nchunks: int, c: int):
    """The output rows chunk ``c`` of ``nchunks`` sums, in its order:
    tiles c, c + C, c + 2C, ... of 256 rows."""
    tiles = -(-rows // DW_TILE)
    out = [torch.arange(t * DW_TILE, min(rows, (t + 1) * DW_TILE))
           for t in range(c, tiles, nchunks)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.long)


def dw_grid(kvol: int, k: int, center_shift: bool, nchunks: int):
    """dW's grid rows in launch order: (tap, chunks of that tap, this
    row's first chunk). The center tap (kz//2 * K + K//2) comes first; a
    submanifold conv reads it at every row, so there it takes
    DW_CENTER_SPLIT rows of C chunks (DW_CENTER_SPLIT * C chunks, row y
    holding chunks y*C .. y*C + C - 1). Then one row of C chunks for each
    other tap of the center's z level (j = kz//2, on a lidar scan's
    surfaces the most present after it), then the other levels' taps in
    order: heavier rows first."""
    kz = kvol // k
    jm = kz // 2
    tc = jm * k + k // 2
    split = DW_CENTER_SPLIT if center_shift else 1
    rows = [(tc, split * nchunks, y * nchunks) for y in range(split)]
    level = [jm * k + kk for kk in range(k) if kk != k // 2]
    rest = [j * k + kk for j in range(kz) if j != jm for kk in range(k)]
    return rows + [(t, nchunks, 0) for t in level + rest]


def _stride(n, cols):
    """Row stride (floats) of n staged channels: consecutive rows 4 cols
    banks apart (csrc/window_conv_bwd.cu::staged_stride)."""
    return n + ((cols * 4 - n) % 32)


def dw_geometry(cin: int, cout: int, center_shift: bool = False):
    """The dW kernel's geometry (csrc/window_conv_bwd.cu::dw_geometry): a
    thread's block (tm x tn: 8 from 32 channels up, the channels padded to
    a multiple of it), the threads of a team (covering dW[t]), the
    teams that split a block's pairs, pairs a ring stage, the staged row
    strides, x copies a row, the center tap's split (``center_shift``)
    and the shared memory a block (bytes)."""
    tm = 8 if cin >= 32 else 4
    tn = 8 if cout >= 32 else 4
    cinp, coutp = -(-cin // tm) * tm, -(-cout // tn) * tn
    nci, ndi = cinp // tm, coutp // tn
    team = nci * ndi
    slices = _THREADS // team
    pairs = max(DW_MIN_PAIRS, 4 * slices)
    lx, ly = _stride(cinp, nci), _stride(coutp, ndi)
    lists = 2 * DW_SEG_TILES * DW_TILE * 4
    ring = DW_STAGES * pairs * (lx + ly) * 4
    smem = max(lists + ring, slices * cinp * coutp * 4)
    return dict(tm=tm, tn=tn, team=team, slices=slices, pairs=pairs, lx=lx,
                ly=ly, xpieces=cin if cin % 4 else cin // 4,
                split=DW_CENTER_SPLIT if center_shift else 1, smem=smem)


def _inv_smem(rb, cin, cout):
    lists = -(-(1 + INV_MAX_TAPS) * rb // 4) * 4
    return (max(2 * (rb + cin) * (cout + 4), rb * (cin + 4)) + lists) * 4


def inv_geometry(cin: int, cout: int):
    """The inverse dX kernel's geometry (csrc/window_conv_bwd.cu::
    inv_geometry): a thread's rows tm (x 4 channels), thread columns nci =
    Cin/4, thread rows used nr, rows a block rb = nr * tm, shared memory a
    block (bytes): the most rows a thread (at most 8, a block at most 256)
    that leave room for two blocks an SM, else for one, else fewer thread
    rows. None where nothing fits."""
    nci = cin // 4
    nri = _THREADS // nci
    for cap in (_TWO_BLOCKS, _MAX_SMEM):
        nr = nri
        while nr >= 1:
            for tm in ((8, 4, 2, 1) if nr == nri else (1,)):
                rb = nr * tm
                if rb <= INV_MAX_ROWS and _inv_smem(rb, cin, cout) <= cap:
                    return dict(tm=tm, nci=nci, nr=nr, rb=rb,
                                smem=_inv_smem(rb, cin, cout))
            nr //= 2
    return None


def inverse_classes(inverse, ncz: int):
    """Each row's parity class as the inverse dX's count kernel finds it:
    bits 28-30 of column 0 (z, y, x), or 8 where no candidate of the row
    is present (its dX is zero). inverse: (B, V, Kc) int32 words."""
    words = inverse.long()
    pmask = ((1 << ncz) - 1) << _PACK_SHIFT
    present = ((words & pmask) != 0).any(-1)
    par = (words[..., 0] >> 28) & 7
    return torch.where(present, par, torch.full_like(par, 8))


def inverse_blocks(inverse, ncz: int, rb: int):
    """The inverse dX kernel's blocks in grid order: (class, rows) with
    rows the flat B*V indices, RB at most, of one class; classes 0-7 in
    turn, each class's rows in row order (a stable grouping), so block b
    of a class holds its ranks [b*rb, (b+1)*rb). Rows of class 8 (nothing
    present) take no block."""
    cls = inverse_classes(inverse, ncz).reshape(-1)
    out = []
    for c in range(8):
        rows = torch.nonzero(cls == c).reshape(-1)
        out += [(c, rows[i:i + rb]) for i in range(0, len(rows), rb)]
    return out


def class_taps(cls: int, kernel, stride):
    """The taps (z-major kk) whose j mod s matches parity class ``cls``
    (bit 0 z, 1 y, 2 x), in tap order."""
    kz, ky, kx = kernel
    par = (cls & 1, (cls >> 1) & 1, (cls >> 2) & 1)
    return [kk for kk in range(kz * ky * kx)
            if all(j % s == p for j, s, p in zip(
                (kk // (ky * kx), (kk // kx) % ky, kk % kx), stride, par))]


def _check_cuda(name, tensors, dtypes):
    dev = tensors[0][1].device
    for tname, t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: {tname} on {t.device}, needs the "
                             f"card {dev}")
        if t.dtype != dtypes[tname]:
            raise ValueError(f"{name}: {tname} must be {dtypes[tname]}, got "
                             f"{t.dtype} (the backward kernels are fp32; "
                             f"bf16 backward: ROADMAP queue 2)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must start on a 16-byte "
                             f"boundary")
    return dev


def window_conv_dw(features, packed, dy, center_shift: bool, kz: int = 3):
    """d(weights) of the window conv: dW[j*K + k] = sum over rows o of
    x[tap row]^T dy[o] over the forward's rulebook (the center column's
    o-1, o, o+1 with ``center_shift``).

    features (B, V, Cin) fp32, Cin 1-128; packed (B, O, K) int32 with kz
    presence bits; dy (B, O, Cout) fp32, Cout a multiple of 4 up to 128.
    Returns (kz*K, Cin, Cout) fp32. On the card one call launches two
    kernels (counted once, ``window_conv_dw.launches``): per-block partials
    of each tap over a chunk of rows (dw_chunks, dw_grid) into a
    workspace (C, kz*K + split - 1, Cin, Cout), then their sum in chunk
    order; no atomics, so two calls give the same bits. CPU tensors take
    window_conv_dw_ref. Counted by the rule ``_dw_work``."""
    with flops.kernel("window_conv_dw", features, packed, dy, center_shift,
                      kz):
        return _dw_call(features, packed, dy, center_shift, kz)


def _dw_work(features, packed, dy, center_shift, kz):
    """(bytes, flops, peak) of one dW: 2 Cin Cout for each tap that reads
    a row (the forward's), the rows, the words, dy read once, dW written
    once; whatever the kernel keeps between its passes is not counted."""
    k = packed.shape[-1]
    cin, cout = features.shape[-1], dy.shape[-1]
    taps, rows = flops.conv_taps(packed, features.shape[1], center_shift, kz)
    nbytes = (rows * cin * 4 + packed.numel() * 4 + dy.numel() * 4
              + kz * k * cin * cout * 4)
    return nbytes, 2.0 * cin * cout * taps, flops.FP32_FLOPS


def _dw_call(features, packed, dy, center_shift, kz):
    if features.device.type == "cpu":
        r0, pres = unpack_windows(packed, kz)
        return window_conv_dw_ref(features, r0, pres, dy, center_shift)
    dev = _check_cuda("window_conv_dw", (("features", features),
                                         ("packed", packed), ("dy", dy)),
                      {"features": torch.float32, "packed": torch.int32,
                       "dy": torch.float32})
    b, v, cin = features.shape
    bo, o, k = packed.shape
    cout = dy.shape[-1]
    if bo != b or dy.shape[:2] != (b, o):
        raise ValueError(f"window_conv_dw: features {tuple(features.shape)}"
                         f", packed {tuple(packed.shape)}, dy "
                         f"{tuple(dy.shape)} disagree")
    if not 0 < kz <= 7 or (center_shift and kz != 3):
        raise ValueError(f"window_conv_dw takes kz 1-7 (3 with "
                         f"center_shift), got {kz}")
    kvol = kz * k
    if not 0 < cin <= _MAX_CIN or cout % 4 or not 0 < cout <= 128:
        raise ValueError(f"window_conv_dw takes Cin 1-{_MAX_CIN} and Cout a "
                         f"multiple of 4 up to 128, got {cin}, {cout}")
    if center_shift and o != v:
        raise ValueError("center_shift needs O == V")
    if v > _PACK_MASK + 1:
        raise ValueError(f"V={v} exceeds the packed rank range")
    rows = b * o
    nchunks = dw_chunks(rows, kvol)
    split = DW_CENTER_SPLIT if center_shift else 1
    ws = torch.empty((nchunks, kvol + split - 1, cin, cout),
                     dtype=torch.float32, device=dev)
    dw = torch.empty((kvol, cin, cout), dtype=torch.float32, device=dev)
    if rows == 0 or v == 0:
        return dw.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().window_conv_dw_launch(
            features.data_ptr(), packed.data_ptr(), dy.data_ptr(),
            ws.data_ptr(), dw.data_ptr(), b, v, o, k, kz, cin, cout,
            int(bool(center_shift)), nchunks, stream)
    if err != 0:
        raise RuntimeError(f"window_conv_dw: CUDA launch failed (cudaError "
                           f"{err})")
    window_conv_dw.launches += 1
    return dw


window_conv_dw.launches = 0


def window_conv_inv(dy, inverse, weights, kernel, stride, v: int):
    """dX of a strided window conv over its packed inverse rulebook:
    dX[q] = sum over taps kk whose parity matches q of dY[row_kk(q)] @
    W[kk]^T (ops/sparse.py::window_conv_inv_ref has the rules).

    dy (B, O, Cout) fp32, Cout a multiple of 4 up to 128; inverse (B, V,
    Kc) int32; weights (kz*ky*kx, Cin, Cout) fp32, Cin a multiple of 4 up
    to 128; ``kernel`` and ``stride`` the conv's (z, y, x) kernel (at most
    3 a dim) and stride (1 or 2 a dim). Returns (B, V, Cin) fp32. On the
    card one call launches two kernels (counted once,
    ``window_conv_inv.launches``): a count of each 1024-row tile's rows of
    each parity class (inverse_classes), then blocks of one class each
    (inverse_blocks) that take only that class's taps (class_taps); the
    workspace (each row's class, the counts) comes from the wrapper. CPU
    tensors take the twin. Counted by utils/flops.py's inverse_work
    rule."""
    k3 = tuple(int(x) for x in kernel)
    s3 = tuple(int(x) for x in stride)
    with flops.kernel("window_conv_inv", dy, inverse, weights, k3, s3, v):
        return _inv_call(dy, inverse, weights, k3, s3, v)


def _inv_call(dy, inverse, weights, k3, s3, v):
    kz, ky, kx = k3
    kvol, cin, cout = weights.shape
    kc = inverse.shape[-1]
    nc = ncand_of(k3, s3)
    if (nc[1] * nc[2] != kc or kz * ky * kx != kvol or max(nc) > 2
            or max(k3) > 3):
        raise ValueError(f"window_conv_inv: weights {tuple(weights.shape)} "
                         f"and stride {s3} do not fit {kc} candidate "
                         f"columns")
    if dy.device.type == "cpu":
        r0i, presi, par = unpack_inverse(inverse, nc[0])
        return window_conv_inv_ref(dy, r0i, presi, par, weights, k3, s3)
    dev = _check_cuda("window_conv_inv", (("dy", dy), ("inverse", inverse),
                                          ("weights", weights)),
                      {"dy": torch.float32, "inverse": torch.int32,
                       "weights": torch.float32})
    b, o, _ = dy.shape
    if inverse.shape[:2] != (b, v) or dy.shape[-1] != cout:
        raise ValueError(f"window_conv_inv: dy {tuple(dy.shape)}, inverse "
                         f"{tuple(inverse.shape)}, weights "
                         f"{tuple(weights.shape)}, V={v} disagree")
    if cin % 4 or not 0 < cin <= _MAX_CIN or cout % 4 or not 0 < cout <= 128:
        raise ValueError(f"window_conv_inv takes Cin and Cout multiples of 4 "
                         f"up to 128, got {cin}, {cout}")
    if any(x not in (1, 2) for x in s3):
        raise ValueError(f"window_conv_inv takes strides 1 or 2, got {s3}")
    if o > _PACK_MASK + 1:
        raise ValueError(f"O={o} exceeds the packed rank range")
    rows = b * v
    dx = torch.empty((b, v, cin), dtype=torch.float32, device=dev)
    cls = torch.empty(rows, dtype=torch.uint8, device=dev)
    counts = torch.empty(8 * -(-rows // INV_COUNT_ROWS), dtype=torch.int32,
                         device=dev)
    if rows == 0:
        return dx
    if o == 0:
        return dx.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().window_conv_inv_launch(
            dy.data_ptr(), inverse.data_ptr(), weights.data_ptr(),
            dx.data_ptr(), cls.data_ptr(), counts.data_ptr(), b, v, o, cin,
            cout, kz, ky, kx, s3[0], s3[1], s3[2], nc[0], stream)
    if err != 0:
        raise RuntimeError(f"window_conv_inv: CUDA launch failed (cudaError "
                           f"{err})")
    window_conv_inv.launches += 1
    return dx


window_conv_inv.launches = 0

flops.register("window_conv", flops.conv_work)
flops.register("window_conv_dw", _dw_work)
flops.register("window_conv_inv", flops.inverse_work)
