"""Sparse window convolution: the CUDA kernel's wrapper and its plain twin.

``window_conv`` replaces det3d_tpu/ops/band_conv.py::band_window_conv (the
Pallas TPU kernel) and, with it, the contract of
det3d_tpu/ops/sparse.py::apply_conv_window. A CUDA tensor launches the
hand-written kernel in ``csrc/window_conv.cu``; a CPU tensor takes
``window_conv_ref`` (ops/sparse.py), the same function in plain PyTorch.
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
from det3d_tpu_torch.ops.sparse import (_PACK_MASK, _PACK_SHIFT,
                                        unpack_windows, window_conv_ref)

__all__ = ["window_conv", "window_conv_ref", "f32_schedule"]

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


def window_conv(features, packed, weights, center_shift: bool):
    """Sparse conv over a packed window rulebook.

    features: (B, V, Cin) fp32 or bf16; packed: (B, O, K) int32 words
    r0 | pres << 24; weights: (kz*K, Cin, Cout) z-major, the features'
    type. ``center_shift``: submanifold rulebook (O == V, kz == 3), whose
    center BEV column reads rows o-1, o, o+1. Returns (B, O, Cout) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    the tensor-core one for bf16 and the CUDA-core one for fp32 (one
    launch, counted in ``window_conv.launches``); any other input raises,
    as do weights off a 16-byte boundary.
    """
    if features.device.type == "cpu":
        kz = weights.shape[0] // packed.shape[-1]
        r0, pres = unpack_windows(packed, kz)
        return window_conv_ref(features, r0, pres, weights, center_shift)
    b, v, o, k, kz, cin, cout = _check(features, packed, weights,
                                       center_shift)
    out = torch.empty((b, o, cout), dtype=torch.float32,
                      device=features.device)
    if b == 0 or o == 0:
        return out
    if v == 0:
        return out.zero_()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().window_conv_launch(
            features.data_ptr(), packed.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, v, o, k, kz, cin, cout, int(bool(center_shift)),
            int(features.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"window_conv: CUDA launch failed (cudaError "
                           f"{err})")
    window_conv.launches += 1
    return out


window_conv.launches = 0
