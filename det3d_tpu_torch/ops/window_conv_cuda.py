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
- dX of a strided conv: ``window_conv_inv``, the kernel
  ``window_conv_inv_kernel`` of ``csrc/window_conv_bwd.cu`` over the
  conv's inverse rulebook (twin ``ops/sparse.py::window_conv_inv_ref``);
  a strided conv without one (more than 2 output candidates a dim, or a
  plan built for serving) takes the flat per-tap backward,
  ``ops/sparse.py::window_to_flat`` and ``flat_conv_dx`` (a scatter-add
  over the taps in plain PyTorch, as the JAX package's VJP is XLA code);
- dW of both: ``window_conv_dw``, the kernels ``window_conv_dw_kernel``
  and ``window_conv_dw_sum_kernel`` of ``csrc/window_conv_bwd.cu`` (per
  block partial sums, then a sum in a fixed order: no atomics, the same
  bits every call; twin ``ops/sparse.py::window_conv_dw_ref``).

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

# dW's first pass: about this many blocks a launch (kvol taps x row
# chunks), rows per chunk a multiple of the kernel's 64-row tile
DW_BLOCKS = 528
DW_TILE = 64


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = csrc.load("window_conv_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_conv_dw_launch.argtypes = [p] * 4 + [i] * 10 + [p]
    lib.window_conv_dw_launch.restype = i
    lib.window_conv_dw_sum_launch.argtypes = [p, p, i, i, p]
    lib.window_conv_dw_sum_launch.restype = i
    lib.window_conv_inv_launch.argtypes = [p] * 4 + [i] * 12 + [p]
    lib.window_conv_inv_launch.restype = i
    return lib


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


def dw_chunks(rows: int, kvol: int) -> int:
    """Rows per block of dW's first pass over ``rows`` = B*O output rows:
    about DW_BLOCKS blocks in all, a multiple of DW_TILE rows. A function
    of the shapes alone, so every call sums in the same order."""
    per = -(-rows // max(1, DW_BLOCKS // kvol))
    return max(DW_TILE, -(-per // DW_TILE) * DW_TILE)


def window_conv_dw(features, packed, dy, center_shift: bool, kz: int = 3):
    """d(weights) of the window conv: dW[j*K + k] = sum over rows o of
    x[tap row]^T dy[o] over the forward's rulebook (the center column's
    o-1, o, o+1 with ``center_shift``).

    features (B, V, Cin) fp32, Cin 1-128; packed (B, O, K) int32 with kz
    presence bits; dy (B, O, Cout) fp32, Cout a multiple of 4 up to 128.
    Returns (kz*K, Cin, Cout) fp32. On the card two launches (one counted,
    ``window_conv_dw.launches``): per-block partials of each tap over a
    chunk of rows into a workspace, then their sum in chunk order; no
    atomics, so two calls give the same bits. CPU tensors take
    window_conv_dw_ref. Counted by the rule ``_dw_work``."""
    with flops.kernel("window_conv_dw", features, packed, dy, center_shift,
                      kz):
        return _dw_call(features, packed, dy, center_shift, kz)


def _dw_work(features, packed, dy, center_shift, kz):
    """(bytes, flops, peak) of one dW: 2 Cin Cout for each tap that reads
    a row (the forward's), the rows, the words, dy read once, dW written
    once."""
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
    chunk = dw_chunks(rows, kvol)
    nchunks = max(1, -(-rows // chunk))
    ws = torch.empty((nchunks, kvol, cin, cout), dtype=torch.float32,
                     device=dev)
    dw = torch.empty((kvol, cin, cout), dtype=torch.float32, device=dev)
    if rows == 0 or v == 0:
        return dw.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().window_conv_dw_launch(
            features.data_ptr(), packed.data_ptr(), dy.data_ptr(),
            ws.data_ptr(), b, v, o, k, kz, cin, cout,
            int(bool(center_shift)), chunk, nchunks, stream)
        if err == 0:
            err = _bwd_lib().window_conv_dw_sum_launch(
                ws.data_ptr(), dw.data_ptr(), nchunks, kvol * cin * cout,
                stream)
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
    3 a dim) and stride (1 or 2 a dim). Returns (B, V, Cin) fp32. One
    launch on the card (``window_conv_inv.launches``); CPU tensors take
    the twin. Counted by utils/flops.py's inverse_work rule."""
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
    dx = torch.empty((b, v, cin), dtype=torch.float32, device=dev)
    if b == 0 or v == 0:
        return dx
    if o == 0:
        return dx.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().window_conv_inv_launch(
            dy.data_ptr(), inverse.data_ptr(), weights.data_ptr(),
            dx.data_ptr(), b, v, o, cin, cout, kz, ky, kx, s3[0], s3[1],
            s3[2], nc[0], stream)
    if err != 0:
        raise RuntimeError(f"window_conv_inv: CUDA launch failed (cudaError "
                           f"{err})")
    window_conv_inv.launches += 1
    return dx


window_conv_inv.launches = 0

flops.register("window_conv", flops.conv_work)
flops.register("window_conv_dw", _dw_work)
flops.register("window_conv_inv", flops.inverse_work)
