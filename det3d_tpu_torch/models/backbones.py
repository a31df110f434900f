"""Backbones: the pillar scatter onto the BEV canvas, and the sparse
middles.

Port of det3d_tpu/models/backbones.py: ``PointPillarsScatter``, and
``SpMiddleFHD``, ``SpMiddleFHDNobn``, ``SpMiddleResNetFHD`` and
``RCNNSpMiddleFHD`` with their layers (``SparseConvBN``, ``DenseConvBN``,
``SparseBasicBlock``, ``DenseBasicBlock``), for serving and training
(``module.train()``: BN on the batch statistics of the active rows, the
strided convs' backward over their inverse rulebooks), from a host plan
or, without one, from the plan ``build_plan_device`` builds on the
device. Grids deeper than 64 take the device plan only: flat rulebooks
at their deep resolutions (ops/sparse.py::Flat, ``flat_conv``), windows
from the first resolution of depth 64 or less. The canvas keeps the
reference's NHWC layout, (B, ny, nx, C). Padded rows (coords -1) are
dropped before every scatter, where the reference sends them to an
out-of-bounds index that XLA drops.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from det3d_tpu_torch.core.voxelize import scatter_rows
from det3d_tpu_torch.models.registry import BACKBONES
from det3d_tpu_torch.utils import trace


@BACKBONES.register_module
class PointPillarsScatter(nn.Module):

    def __init__(self, num_input_features: int = 64,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 1,
                 name_str: str = "PointPillarsScatter"):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxel_features, coords, input_shape):
        """voxel_features (B, V, C); coords (B, V, 3) zyx, -1 rows padded;
        input_shape (nx, ny, nz). Returns the (B, ny, nx, C) canvas."""
        nx, ny = int(input_shape[0]), int(input_shape[1])
        b, _, c = voxel_features.shape
        y = coords[..., 1].long()
        x = coords[..., 2].long()
        valid = (y >= 0) & (x >= 0)
        base = torch.arange(b, device=y.device)[:, None] * (ny * nx)
        canvas = scatter_rows(voxel_features, base + y * nx + x, valid,
                              b * ny * nx)
        return canvas.view(b, ny, nx, c)


# ---------------------------------------------------------------------------
# The SECOND and CBGS sparse middles
# ---------------------------------------------------------------------------

from det3d_tpu_torch.models.norm import build_norm  # noqa: E402
from det3d_tpu_torch.models.precision import act_dtype  # noqa: E402
from det3d_tpu_torch.ops import sparse as sp  # noqa: E402
from det3d_tpu_torch.ops.window_conv_cuda import window_conv  # noqa: E402

# stage geometry (kernel, stride, padding) shared by the SpMiddle variants
_STAGE_GEOM = ((3, 2, (1, 1, 1)), (3, 2, (1, 1, 1)), (3, 2, (0, 1, 1)),
               ((3, 1, 1), (2, 1, 1), (0, 0, 0)))


def middle_plan_spec(middle, input_shape, max_voxels, host: bool = True):
    """Static description of the rulebooks a sparse middle reads.

    ``middle``: the middle module, or a dict / object with its attributes
    (stage_caps, dense_tail, dense_from, pre_ranked). Returns a plain dict:
    shape0, v, pre_ranked, stages = (kernel, stride, padding, cap, subm).
    A host plan (``host``, the default) holds the bitmap regime only and
    raises for a grid deeper than 64, as the JAX package asserts; the
    device plan (``host=False``) takes any depth. Port of
    det3d_tpu/models/backbones.py::middle_plan_spec."""
    def get(name, default):
        if isinstance(middle, dict):
            return middle.get(name, default)
        return getattr(middle, name, default)

    nx, ny, nz = (int(s) for s in input_shape)
    shape0 = (nz + 1, ny, nx)
    if host:
        sp.check_depth(shape0[0])
    v = int(max_voxels)
    caps = [max(64, int(v * f)) for f in get("stage_caps", (1.0,) * 4)]
    dense_tail = bool(get("dense_tail", False))
    start = max(1, int(get("dense_from", 3))) if dense_tail else 4
    stages = []
    for i, (k, s, p) in enumerate(_STAGE_GEOM, start=1):
        if i > start:
            break
        stages.append({"kernel": sp._as3(k), "stride": sp._as3(s),
                       "padding": sp._as3(p), "cap": caps[i - 1],
                       "subm": i < start})
    return {"shape0": shape0, "v": v,
            "pre_ranked": bool(get("pre_ranked", False)),
            "stages": tuple(stages)}


class SparseConvBN(nn.Module):
    """Sparse conv over a packed window rulebook, optional bias, BN and
    optional ReLU.

    The conv runs in ``precision``, or in the ``dtype`` a call passes (its
    operands cast to it, fp32 sums, fp32 output): the CUDA kernels for
    card tensors, their plain twins for CPU tensors
    (ops/window_conv_cuda.py::window_conv, differentiable; a strided conv
    takes its ``inverse`` rulebook for its dX). Bias (added before the BN,
    as the JAX package does), BN and ReLU run in fp32; in training the
    BN's batch statistics cover the rows ``valid`` selects. The weight
    keeps the JAX package's (kz*ky*kx, Cin, Cout) z-major layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[dict] = None, precision: str = "fp32",
                 kvol: int = 27, use_bias: bool = False, relu: bool = True,
                 use_norm: bool = True):
        super().__init__()
        self.dtype = act_dtype(precision)
        self.relu = relu
        self.weight = nn.Parameter(torch.empty(kvol, in_channels,
                                               out_channels))
        bound = (3.0 / (kvol * in_channels)) ** 0.5  # flax fan_in uniform
        nn.init.uniform_(self.weight, -bound, bound)
        # without BN (the Nobn middles) the conv always has its bias
        self.bias = (nn.Parameter(torch.zeros(out_channels))
                     if use_bias or not use_norm else None)
        self.norm = build_norm(norm_cfg, out_channels) if use_norm else None

    def forward(self, x, packed, center_shift: bool, dtype=None,
                valid=None, inverse=None):
        """``packed``: a packed window rulebook, or a deep resolution's
        flat one (ops/sparse.py::Flat), which flat_conv runs (its
        submanifold center column by rank shifts)."""
        dt = dtype or self.dtype
        if isinstance(packed, sp.Flat):
            y = sp.flat_conv(x.to(dt), packed.idx, packed.mask,
                             self.weight.to(dt),
                             sp.center_column_taps(3) if center_shift
                             else None)
        else:
            y = window_conv(x.to(dt).contiguous(), packed.contiguous(),
                            self.weight.to(dt).contiguous(), center_shift,
                            inverse)
        if self.bias is not None:
            y = y + self.bias
        if self.norm is not None:
            y = self.norm(y, mask=valid)
        return torch.relu(y) if self.relu else y


class SparseBasicBlock(nn.Module):
    """Residual block of two biased submanifold convs on one rulebook, the
    second without ReLU, then relu(x + y), all in fp32 (the convs' BN
    leaves fp32). Port of det3d_tpu/models/backbones.py::SparseBasicBlock
    (reference scn.py:46-89)."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None,
                 precision: str = "fp32"):
        super().__init__()
        self.SparseConvBN_0 = SparseConvBN(channels, channels, norm_cfg,
                                           precision, use_bias=True)
        self.SparseConvBN_1 = SparseConvBN(channels, channels, norm_cfg,
                                           precision, use_bias=True,
                                           relu=False)

    def forward(self, x, packed, dtype=None, valid=None):
        y = self.SparseConvBN_0(x, packed, True, dtype, valid)
        y = self.SparseConvBN_1(y, packed, True, dtype, valid)
        return torch.relu(x + y)


# cuDNN 9.22 (PyTorch 2.11) on the H100, fp32 with TF32 off, runs Lyft's
# 3x3x3 stride-1 conv from 128 to 128 channels over (2, 5, 252, 252) at 27
# TFLOP/s (21.0 ms), and as two convs of 64 output channels each at 40
# (14.1 ms, their concatenation included); its strided convs to 128
# channels run slower split (chip_smoke.py phase 30 times each both ways).
COUT_CHUNK = 64


class DenseConvBN(nn.Module):
    """Dense-tail twin of SparseConvBN: conv3d, optional bias, BN (in
    training on the statistics of the active sites), optional ReLU,
    re-zeroed off the active sites.

    Tensors are NDHWC; the conv runs on NCDHW views of them. The conv is
    PyTorch's conv3d (the JAX package leaves this one to XLA, outside any
    Pallas kernel); an fp32 stride-1 conv to more than COUT_CHUNK channels
    runs as convs of COUT_CHUNK output channels each, concatenated. With
    bf16 the whole epilogue (the bias among it) stays in bf16, as the JAX
    package serves it. A call's ``dtype`` overrides ``precision``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel=(3, 3, 3), stride=(1, 1, 1), padding=(1, 1, 1),
                 norm_cfg: Optional[dict] = None, precision: str = "fp32",
                 use_bias: bool = False, relu: bool = True,
                 use_norm: bool = True):
        super().__init__()
        self.kernel, self.stride, self.padding = (
            sp._as3(kernel), sp._as3(stride), sp._as3(padding))
        self.dtype = act_dtype(precision)
        self.relu = relu
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *self.kernel))
        fan_in = in_channels * self.weight[0, 0].numel()
        bound = (3.0 / fan_in) ** 0.5
        nn.init.uniform_(self.weight, -bound, bound)
        self.bias = (nn.Parameter(torch.zeros(out_channels))
                     if use_bias or not use_norm else None)
        self.norm = (build_norm(norm_cfg, out_channels, dtype=self.dtype)
                     if use_norm else None)

    def conv(self, x, dtype=None):
        """The conv3d of NCDHW ``x`` in ``dtype`` (default: the layer's)."""
        dt = dtype or self.dtype
        w = self.weight.to(dt)
        kw = dict(stride=self.stride, padding=self.padding)
        if (dt == torch.float32 and self.stride == (1, 1, 1)
                and w.shape[0] > COUT_CHUNK):
            return torch.cat([F.conv3d(x, w[i:i + COUT_CHUNK], **kw)
                              for i in range(0, w.shape[0], COUT_CHUNK)],
                             dim=1)
        return F.conv3d(x, w, **kw)

    def forward(self, x, occ_out, dtype=None):
        dt = dtype or self.dtype
        y = self.conv(x.to(dt).permute(0, 4, 1, 2, 3), dt).permute(
            0, 2, 3, 4, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.norm is not None:
            y = self.norm(y, mask=occ_out, dtype=dtype)
        if self.relu:
            y = torch.relu(y)
        return y * occ_out[..., None].to(y.dtype)


class DenseBasicBlock(nn.Module):
    """Dense-tail twin of SparseBasicBlock: two biased DenseConvBNs, then
    relu(x + y) in the activation dtype (bf16 when serving bf16), re-masked
    by the occupancy. Port of det3d_tpu/models/backbones.py::
    DenseBasicBlock."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None,
                 precision: str = "fp32"):
        super().__init__()
        self.DenseConvBN_0 = DenseConvBN(channels, channels,
                                         norm_cfg=norm_cfg,
                                         precision=precision, use_bias=True)
        self.DenseConvBN_1 = DenseConvBN(channels, channels,
                                         norm_cfg=norm_cfg,
                                         precision=precision, use_bias=True,
                                         relu=False)

    def forward(self, x, occ, dtype=None):
        y = self.DenseConvBN_0(x, occ, dtype)
        y = self.DenseConvBN_1(y, occ, dtype)
        return torch.relu(x + y) * occ[..., None].to(x.dtype)


def _occupancy(coords, shape):
    """(B, V, 3) zyx -> (B, D, H, W) bool active-site mask."""
    d, h, w = shape
    b = coords.shape[0]
    n = d * h * w
    lin = sp.linearize(coords, shape)
    keep = lin != sp._SENTINEL
    flat = torch.arange(b, device=lin.device)[:, None] * n + lin
    occ = torch.zeros(b * n + 1, dtype=torch.bool, device=lin.device)
    # index_fill_ takes the value as a kernel argument; ``occ[idx] = True``
    # would copy it from host memory and wait
    occ.index_fill_(0, torch.where(keep, flat, b * n).reshape(-1), True)
    return occ[:-1].view(b, d, h, w)


def _cover_mask(occ, kernel, stride, padding):
    """Occupancy of a strided conv's output set: every output whose
    footprint covers an active input, a max-pool of the occupancy."""
    return F.max_pool3d(occ[:, None].float(), kernel, stride,
                        padding)[:, 0] > 0


def _fold_depth(dense):
    """(B, D, H, W, C) -> (B, H, W, C*D), channel-major as the reference's
    view(N, C*D, H, W)."""
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)


def _bev_reshape(features, coords, shape):
    """Scatter the last sparse stage to dense and fold depth."""
    return _fold_depth(sp.to_dense(features, coords, shape))


def _res0_lookup(coords, shape0, pre_ranked):
    """Rank-order the res0 rows and build their lookup. Returns (order0 or
    None when the voxelizer already emitted rank order, coords in rank
    order, lookup). A deep grid's res0 is reordered and takes
    stage_lookup_batch's table whatever ``pre_ranked`` says, as in the JAX
    package. Port of backbones.py::_res0_lookup, without the feature
    gather: the plan carries order0 to _res0_with_plan."""
    if pre_ranked and shape0[0] <= sp.MAX_BITMAP_DEPTH:
        return None, coords, sp.build_bitmap_batch(coords, shape0)
    return sp.stage_lookup_batch(coords, shape0)


def _pack(rulebook):
    """A window rulebook packed (pack_windows), a flat one as sp.Flat."""
    a, b = rulebook
    return sp.pack_windows(a, b) if b.dim() == 4 else sp.Flat(a, b)


def _stage_rulebooks(coords, shape, kernel, stride, padding, max_out,
                     in_lookup, build_subm, build_inverse=False):
    """One downsample stage on the device: the output coords
    (conv_out_coords, the low-z prefix kept under ``max_out``), reordered
    into the new resolution's rank order, its bitmap when ``build_subm``
    or ``build_inverse``, its subm window rulebook when ``build_subm``, the
    down conv's window rulebook over the input bitmap and, with
    ``build_inverse``, the down conv's packed inverse rulebook over the
    output bitmap. Port of backbones.py::_stage_rulebooks, its sorted
    branch.

    Rows go into rank order at every stage, also at one that builds no
    lookup (the dense tail's transition, the sparse z conv), where the
    JAX package's evaluation keeps conv_out_coords' zyx order: the host
    plan's order, which that stage's consumers (to_dense, the BEV scatter)
    do not see. Returns (coords, (r0, pres) down, (r0, pres) subm or None,
    out shape, bitmap or None, packed inverse or None)."""
    out_co, oshape = sp.conv_out_coords(coords, shape, kernel, stride,
                                        padding, max_out)
    lookup = subm = inverse = None
    if build_subm or build_inverse:
        _, out_co, lookup = sp.stage_lookup_batch(out_co, oshape)
    else:
        order = sp.yxz_order(out_co, oshape)
        out_co = torch.gather(out_co, 1, order[..., None].expand(-1, -1, 3))
    if build_subm:
        subm = sp.subm_window_rulebook_batch(out_co, oshape, 3, lookup)
    down = sp.conv_window_rulebook_batch(shape, out_co, kernel, stride,
                                         padding, in_lookup)
    if build_inverse:
        inv = sp.strided_inverse_rulebook_batch(coords, kernel, stride,
                                                padding, lookup, oshape)
        inverse = None if inv is None else sp.pack_inverse(*inv)
    return out_co, down, subm, oshape, lookup, inverse


def build_plan_device(coords, spec, train: bool = False):
    """The packed rulebook plan of (B, V, 3) voxel coords, built on the
    device: the keys of ops/sparse_host.py::build_plan without ``plan_``
    (order0 when not pre_ranked, s0, co{i}, down{i}, subm{i}, and with
    ``train`` the inverse rulebooks inv{i}), int32, equal to the host plan
    array for array. Plain PyTorch with fixed shapes and no host round
    trip, so a captured step holds it. A grid deeper than 64 gets flat
    rulebooks (sp.Flat) at its deep resolutions and ``order0`` whatever
    ``pre_ranked`` says. Port of backbones.py::build_plan_device."""
    shape0 = tuple(spec["shape0"])
    plan = {}
    order0, co, lookup = _res0_lookup(coords, shape0, spec["pre_ranked"])
    if order0 is not None:
        plan["order0"] = order0.to(torch.int32)
    plan["s0"] = _pack(sp.subm_window_rulebook_batch(co, shape0, 3, lookup))
    shape = shape0
    for i, st in enumerate(spec["stages"], start=1):
        co, down, subm, shape, lookup, inverse = _stage_rulebooks(
            co, shape, st["kernel"], st["stride"], st["padding"], st["cap"],
            lookup, st["subm"], train)
        if inverse is not None:
            plan[f"inv{i}"] = inverse
        plan[f"co{i}"] = sp.linearize(co, shape).to(torch.int32)
        plan[f"down{i}"] = _pack(down)
        if st["subm"]:
            plan[f"subm{i}"] = _pack(subm)
    return plan


def _plan_and_dtype(middle, coords, input_shape, plan):
    """(plan, dtype of the call). Serving from a host plan: the layers'
    own dtype (``serve_precision`` when set). Without a plan the middle
    builds it on the device (a training plan in training) and computes in
    ``precision``, as the JAX package computes its middles in
    ``serve_precision`` only when a plan is given; in training it computes
    in ``precision`` from a host plan too (JAX: ``serving = plan is not
    None and not train``)."""
    dt = middle.plain_dtype if middle.training else None
    if plan is not None:
        return plan, dt
    spec = middle_plan_spec(middle, input_shape, coords.shape[1],
                            host=False)
    with trace.segment("plan"):
        plan = build_plan_device(coords, spec, train=middle.training)
    return plan, middle.plain_dtype


def _res0_with_plan(voxel_features, coords, pre_ranked, plan):
    """Rank-order the res0 rows from the plan's order0 (unless the
    voxelizer already emitted them in rank order and the grid is shallow
    enough for the plan to have none). Returns (features, coords)."""
    if not pre_ranked or "order0" in plan:
        order0 = plan["order0"].long()
        coords = torch.gather(coords, 1, order0[..., None].expand(-1, -1, 3))
        voxel_features = torch.gather(
            voxel_features, 1,
            order0[..., None].expand(-1, -1, voxel_features.shape[-1]))
    return voxel_features, coords


def _plan_stage(plan, i, in_shape, kernel, stride, padding):
    """Stage ``i`` of a packed plan: (coords (B, cap, 3), down rulebook,
    subm rulebook or None, out shape, the down conv's inverse: (packed
    inverse rulebook, kernel, stride) or None when the plan has none)."""
    oshape = sp.out_spatial_shape(in_shape, kernel, stride, padding)
    co = sp.delinearize(plan[f"co{i}"], oshape)
    inv = plan.get(f"inv{i}")
    inverse = (None if inv is None
               else (inv, sp._as3(kernel), sp._as3(stride)))
    return co, plan[f"down{i}"], plan.get(f"subm{i}"), oshape, inverse


def _valid(coords, training):
    """The rows whose BN statistics count in training: coords not -1."""
    return coords[..., 0] >= 0 if training else None


# (channels, n_subm, kernel, stride, padding) per downsample stage
_SPECS = ((32, 2, 3, 2, 1), (64, 3, 3, 2, 1), (64, 3, 3, 2, (0, 1, 1)))


@BACKBONES.register_module
class SpMiddleFHD(nn.Module):
    """SECOND sparse middle. Port of
    det3d_tpu/models/backbones.py::SpMiddleFHD.

    Input: voxel_features (B, V, C), coords (B, V, 3) int32 zyx (-1 pad),
    input_shape (nx, ny, nz), and the host plan (ops/sparse_host.py, keys
    without their ``plan_`` prefix) or None. Output: (B, ny/8, nx/8, 64 *
    D_final). Stages before ``dense_from`` run sparse window convs; with
    ``dense_tail`` the rest run masked dense conv3d. From a host plan the
    middle computes in ``serve_precision`` when set, else ``precision``;
    without one it builds the plan on the device (build_plan_device) and
    computes in ``precision``, as the JAX package's ``plan=None`` path
    does. In training (``module.train()``) it computes in ``precision``
    from either plan (a training plan: host_plan_fn(train=True) or
    build_plan_device(train=True)), densifies in fp32, and passes each
    strided conv its inverse rulebook. The ``serve_*band`` keys tune the
    TPU kernel's band and are ignored: the CUDA kernel has no band.

    Modules carry the flax names in call order (``SparseConvBN_<n>``,
    ``DenseConvBN_<n>``), so utils/convert.py::from_jax maps one to one.
    ``use_norm=False`` drops every BN and gives every conv its bias
    (SpMiddleFHDNobn).
    """

    def __init__(self, num_input_features: int = 128,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 8,
                 stage_caps: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 use_norm: bool = True, dense_tail: bool = True,
                 dense_from: int = 3, precision: str = "fp32",
                 pre_ranked: bool = False, serve_band=None,
                 serve_col_band=None, serve_down_band=None,
                 serve_down_col_band=None,
                 serve_precision: Optional[str] = None,
                 name_str: str = "SpMiddleFHD"):
        super().__init__()
        self.stage_caps = tuple(stage_caps)
        self.dense_tail = bool(dense_tail)
        self.dense_from = int(dense_from)
        self.pre_ranked = bool(pre_ranked)
        self.start = max(1, self.dense_from) if self.dense_tail else 4
        prec = serve_precision or precision
        self.dtype = act_dtype(prec)
        self.plain_dtype = act_dtype(precision)
        self._sparse, self._dense = [], []      # module names, call order

        def scb(cin, cout, kvol=27):
            name = f"SparseConvBN_{len(self._sparse)}"
            self.add_module(name, SparseConvBN(cin, cout, norm_cfg,
                                               precision=prec, kvol=kvol,
                                               use_norm=use_norm))
            self._sparse.append(name)

        def dcb(cin, cout, **kw):
            name = f"DenseConvBN_{len(self._dense)}"
            self.add_module(name, DenseConvBN(
                cin, cout, norm_cfg=norm_cfg, precision=prec,
                use_norm=use_norm, **kw))
            self._dense.append(name)

        scb(num_input_features, 16)
        scb(16, 16)
        cin = 16
        for i, (ch, n_subm, k, s, p) in enumerate(_SPECS, start=1):
            if i <= self.start:
                scb(cin, ch)            # the down conv (or the transition)
            else:
                dcb(cin, ch, kernel=k, stride=s, padding=p)
            for _ in range(n_subm):
                (scb if i < self.start else dcb)(ch, ch)
            cin = ch
        if self.start < 4:
            dcb(64, 64, kernel=(3, 1, 1), stride=(2, 1, 1), padding=0)
        else:
            scb(64, 64, kvol=3)

    def forward(self, voxel_features, coords, input_shape, plan=None):
        plan, dt = _plan_and_dtype(self, coords, input_shape, plan)
        nx, ny, nz = (int(s) for s in input_shape)
        shape = (nz + 1, ny, nx)
        convs = iter([getattr(self, n) for n in self._sparse])
        dconvs = iter([getattr(self, n) for n in self._dense])

        x, coords = _res0_with_plan(voxel_features, coords, self.pre_ranked,
                                    plan)
        s0 = plan["s0"]
        valid = _valid(coords, self.training)
        x = next(convs)(x, s0, True, dt, valid)
        x = next(convs)(x, s0, True, dt, valid)

        xd = occ = co = None
        with contextlib.ExitStack() as tail:
            for i, (ch, n_subm, k, s, p) in enumerate(_SPECS, start=1):
                if i <= self.start:
                    co, down, subm, shape, inv = _plan_stage(plan, i, shape,
                                                             k, s, p)
                    valid = _valid(co, self.training)
                    x = next(convs)(x, down, False, dt, valid, inv)
                    if i < self.start:
                        for _ in range(n_subm):
                            x = next(convs)(x, subm, True, dt, valid)
                        continue
                    # transition: densify this stage
                    tail.enter_context(trace.segment("dense_tail"))
                    occ = _occupancy(co, shape)
                    xd = sp.to_dense(x.to(dt or self.dtype), co, shape)
                else:
                    k3, s3, p3 = sp._as3(k), sp._as3(s), sp._as3(p)
                    occ = _cover_mask(occ, k3, s3, p3)
                    xd = next(dconvs)(xd, occ, dt)
                for _ in range(n_subm):
                    xd = next(dconvs)(xd, occ, dt)

            if xd is not None:
                occ4 = _cover_mask(occ, (3, 1, 1), (2, 1, 1), (0, 0, 0))
                return _fold_depth(next(dconvs)(xd, occ4, dt))
        co4, down, _, shape4, inv = _plan_stage(plan, 4, shape, (3, 1, 1),
                                                (2, 1, 1), 0)
        x = next(convs)(x, down, False, dt, _valid(co4, self.training), inv)
        return _bev_reshape(x, co4, shape4)


# (channels, kernel, stride, padding) per downsample stage of the CBGS middle
_RES_SPECS = ((32, 3, 2, 1), (64, 3, 2, 1), (128, 3, 2, (0, 1, 1)))


@BACKBONES.register_module
class SpMiddleResNetFHD(nn.Module):
    """CBGS residual sparse middle. Port of
    det3d_tpu/models/backbones.py::SpMiddleResNetFHD (reference
    scn.py:308-370).

    The stem SparseConvBN and two SparseBasicBlocks at res0; per stage
    before ``dense_from`` a strided SparseConvBN and two SparseBasicBlocks;
    at ``dense_from`` the strided conv, then ``to_dense`` in the activation
    dtype and two DenseBasicBlocks; after it a strided DenseConvBN and two
    DenseBasicBlocks; then the (3, 1, 1) z conv to 128 channels. Without
    ``dense_tail`` every stage and the z conv stay sparse. Input, output
    and precision as SpMiddleFHD's (output (B, ny/8, nx/8, 128 *
    D_final)): without a plan it builds one on the device and computes in
    ``precision``, and in training computes in ``precision`` from either
    plan. The ``serve_*band`` keys are accepted and ignored likewise.

    Modules carry flax's names in call order at each level
    (``SparseConvBN_<n>``, ``SparseBasicBlock_<n>``, ``DenseBasicBlock_<n>``,
    ``DenseConvBN_<n>``; each block holds ``<Layer>_0`` and ``<Layer>_1``),
    so utils/convert.py::from_jax maps one to one.
    """

    def __init__(self, num_input_features: int = 128,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 8,
                 stage_caps: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 dense_tail: bool = True, dense_from: int = 3,
                 precision: str = "fp32", pre_ranked: bool = False,
                 serve_band=None, serve_col_band=None, serve_down_band=None,
                 serve_down_col_band=None,
                 serve_precision: Optional[str] = None,
                 name_str: str = "SpMiddleResNetFHD"):
        super().__init__()
        self.stage_caps = tuple(stage_caps)
        self.dense_tail = bool(dense_tail)
        self.dense_from = int(dense_from)
        self.pre_ranked = bool(pre_ranked)
        self.start = max(1, self.dense_from) if self.dense_tail else 4
        prec = serve_precision or precision
        self.dtype = act_dtype(prec)
        self.plain_dtype = act_dtype(precision)
        self._names = {}                        # class -> names, call order

        def add(module):
            cls = type(module).__name__
            names = self._names.setdefault(cls, [])
            names.append(f"{cls}_{len(names)}")
            self.add_module(names[-1], module)

        def blocks(ch, dense):
            for _ in range(2):
                add((DenseBasicBlock if dense else SparseBasicBlock)(
                    ch, norm_cfg, prec))

        add(SparseConvBN(num_input_features, 16, norm_cfg, prec))
        blocks(16, False)
        cin = 16
        for i, (ch, k, s, p) in enumerate(_RES_SPECS, start=1):
            if i <= self.start:
                add(SparseConvBN(cin, ch, norm_cfg, prec))
            else:
                add(DenseConvBN(cin, ch, kernel=k, stride=s, padding=p,
                                norm_cfg=norm_cfg, precision=prec))
            blocks(ch, i >= self.start)
            cin = ch
        if self.start < 4:
            add(DenseConvBN(128, 128, kernel=(3, 1, 1), stride=(2, 1, 1),
                            padding=0, norm_cfg=norm_cfg, precision=prec))
        else:
            add(SparseConvBN(128, 128, norm_cfg, prec, kvol=3))

    def forward(self, voxel_features, coords, input_shape, plan=None):
        plan, dt = _plan_and_dtype(self, coords, input_shape, plan)
        nx, ny, nz = (int(s) for s in input_shape)
        shape = (nz + 1, ny, nx)
        mods = {cls: iter([getattr(self, n) for n in names])
                for cls, names in self._names.items()}
        scb, dcb = mods["SparseConvBN"], mods.get("DenseConvBN")

        x, coords = _res0_with_plan(voxel_features, coords, self.pre_ranked,
                                    plan)
        s0 = plan["s0"]
        valid = _valid(coords, self.training)
        x = next(scb)(x, s0, True, dt, valid)
        for _ in range(2):
            x = next(mods["SparseBasicBlock"])(x, s0, dt, valid)

        xd = occ = None
        with contextlib.ExitStack() as tail:
            for i, (ch, k, s, p) in enumerate(_RES_SPECS, start=1):
                if i <= self.start:
                    co, down, subm, shape, inv = _plan_stage(plan, i, shape,
                                                             k, s, p)
                    valid = _valid(co, self.training)
                    x = next(scb)(x, down, False, dt, valid, inv)
                    if i < self.start:
                        for _ in range(2):
                            x = next(mods["SparseBasicBlock"])(x, subm, dt,
                                                               valid)
                        continue
                    # transition: densify this stage in the activation dtype
                    tail.enter_context(trace.segment("dense_tail"))
                    occ = _occupancy(co, shape)
                    xd = sp.to_dense(x.to(dt or self.dtype), co, shape)
                else:
                    occ = _cover_mask(occ, sp._as3(k), sp._as3(s),
                                      sp._as3(p))
                    xd = next(dcb)(xd, occ, dt)
                for _ in range(2):
                    xd = next(mods["DenseBasicBlock"])(xd, occ, dt)

            if xd is not None:
                occ4 = _cover_mask(occ, (3, 1, 1), (2, 1, 1), (0, 0, 0))
                return _fold_depth(next(dcb)(xd, occ4, dt))
        co4, down, _, shape4, inv = _plan_stage(plan, 4, shape, (3, 1, 1),
                                                (2, 1, 1), 0)
        x = next(scb)(x, down, False, dt, _valid(co4, self.training), inv)
        return _bev_reshape(x, co4, shape4)


@BACKBONES.register_module
class SpMiddleFHDNobn(SpMiddleFHD):
    """SpMiddleFHD with every BN removed and every conv biased, sparse
    part and dense tail alike (reference scn.py:200-305). Port of
    det3d_tpu/models/backbones.py::SpMiddleFHDNobn, which takes no
    ``precision`` (fp32; ``serve_precision`` when set) and nests an
    SpMiddleFHD (flax's ``SpMiddleFHD_0``, which from_jax strips)."""

    def __init__(self, num_input_features: int = 128,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 8,
                 stage_caps: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 dense_tail: bool = True, dense_from: int = 3,
                 pre_ranked: bool = False, serve_band=None,
                 serve_precision: Optional[str] = None,
                 name_str: str = "SpMiddleFHDNobn"):
        super().__init__(num_input_features, norm_cfg, ds_factor,
                         stage_caps, use_norm=False, dense_tail=dense_tail,
                         dense_from=dense_from, pre_ranked=pre_ranked,
                         serve_precision=serve_precision)


# (channels, kernel, stride, padding) per downsample stage of the RCNN
# middle, each stage's down conv followed by one submanifold conv
_RCNN_SPECS = ((32, 3, 2, 1), (64, 3, 2, 1), (64, 3, 2, (0, 1, 1)))


@BACKBONES.register_module
class RCNNSpMiddleFHD(nn.Module):
    """The cropped-region sparse middle of the two-stage RCNN experiments
    (reference scn.py:373-457): SpMiddleFHD's schedule with one
    submanifold conv a stage, channels 16-32-64-64-64, no dense tail, and
    the trailing (3, 1, 1) / (2, 1, 1) z conv. Port of
    det3d_tpu/models/backbones.py::RCNNSpMiddleFHD: fp32, BN without conv
    biases, every conv a window conv (flat at a deep grid's resolutions),
    from a host plan or the device plan (``middle_plan_spec`` with
    ``dense_tail=False``). Output (B, ny/8, nx/8, 64 * D_final). Modules
    ``SparseConvBN_0`` to ``SparseConvBN_8`` in call order, flax's names.
    """

    dense_tail = False
    dense_from = 4

    def __init__(self, num_input_features: int = 128,
                 norm_cfg: Optional[dict] = None, ds_factor: int = 8,
                 stage_caps: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 pre_ranked: bool = False,
                 name_str: str = "RCNNSpMiddleFHD"):
        super().__init__()
        self.stage_caps = tuple(stage_caps)
        self.pre_ranked = bool(pre_ranked)
        self.dtype = self.plain_dtype = torch.float32
        chans = [16, 16]
        for ch, *_ in _RCNN_SPECS:
            chans += [ch, ch]
        chans.append(64)
        cin = num_input_features
        for n, ch in enumerate(chans):
            self.add_module(f"SparseConvBN_{n}", SparseConvBN(
                cin, ch, norm_cfg, kvol=3 if n == len(chans) - 1 else 27))
            cin = ch

    def forward(self, voxel_features, coords, input_shape, plan=None):
        plan, dt = _plan_and_dtype(self, coords, input_shape, plan)
        nx, ny, nz = (int(s) for s in input_shape)
        shape = (nz + 1, ny, nx)
        convs = iter([getattr(self, f"SparseConvBN_{n}") for n in range(9)])

        x, coords = _res0_with_plan(voxel_features, coords, self.pre_ranked,
                                    plan)
        valid = _valid(coords, self.training)
        x = next(convs)(x, plan["s0"], True, dt, valid)
        x = next(convs)(x, plan["s0"], True, dt, valid)
        for i, (_, k, s, p) in enumerate(_RCNN_SPECS, start=1):
            co, down, subm, shape, inv = _plan_stage(plan, i, shape, k, s, p)
            valid = _valid(co, self.training)
            x = next(convs)(x, down, False, dt, valid, inv)
            x = next(convs)(x, subm, True, dt, valid)
        co4, down, _, shape4, inv = _plan_stage(plan, 4, shape, (3, 1, 1),
                                                (2, 1, 1), 0)
        x = next(convs)(x, down, False, dt, _valid(co4, self.training), inv)
        return _bev_reshape(x, co4, shape4)
