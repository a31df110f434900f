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

The dense tail (the stages from ``dense_from`` on) holds the weights of
the JAX package's masked dense conv3d tail, which is a submanifold or
strided sparse conv over the active sites with every output kept. On the
card it runs on those sites alone (``_RowsTail``): a TPU runs a dense
conv3d faster than rulebook gathers, but cuDNN's conv3d over the whole
grid spends most of its products on empty sites (93% at CBGS's res2 and
res3 on nuScenes scans), where the window-conv kernels spend none. The
dense forwards of ``DenseConvBN`` and ``DenseBasicBlock`` are the twins
the tests hold the JAX package's layers and the rows tail to.
"""

from __future__ import annotations

import math
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


def _conv(x, packed, weight, center_shift, dt, inverse=None):
    """Rows ``x`` convolved over ``packed`` with z-major ``weight`` (kvol,
    Cin, Cout), operands in ``dt``, fp32 sums and output: window_conv over
    a packed window rulebook, flat_conv over a deep resolution's flat one
    (its submanifold center column by rank shifts)."""
    if isinstance(packed, sp.Flat):
        return sp.flat_conv(x.to(dt), packed.idx, packed.mask, weight.to(dt),
                            sp.center_column_taps(3) if center_shift
                            else None)
    return window_conv(x.to(dt).contiguous(), packed.contiguous(),
                       weight.to(dt).contiguous(), center_shift, inverse)


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
        y = _conv(x, packed, self.weight, center_shift, dtype or self.dtype,
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


class DenseConvBN(nn.Module):
    """A dense-tail layer: conv, optional bias, BN (in training on the
    statistics of the active sites), optional ReLU.

    ``rows`` runs it on the active sites alone, the main path: the conv
    over a window rulebook (models/backbones.py::_RowsTail builds it),
    through ops/window_conv_cuda.py::window_conv as SparseConvBN's, the
    weight read as z-major (kz*ky*kx, Cin, Cout) taps. ``forward`` is its
    dense twin on NDHWC tensors (the conv3d of NCDHW views, re-zeroed off
    the active sites), the JAX package's layer. The weight keeps conv3d's
    (Cout, Cin, kz, ky, kx) layout in both. With bf16 the whole epilogue
    (the bias among it) stays in bf16, as the JAX package serves it. A
    call's ``dtype`` overrides ``precision``."""

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

    def _epilogue(self, y, mask, dtype):
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.norm is not None:
            y = self.norm(y, mask=mask, dtype=dtype)
        return torch.relu(y) if self.relu else y

    def rows(self, x, packed, dtype=None, valid=None, inverse=None):
        """The layer on rows ``x`` (B, V, Cin): ``packed`` is the
        submanifold rulebook of the rows for a stride-1 layer, else the
        strided conv's over the input rows (a deep resolution's flat one
        where the bitmap cannot hold it); ``valid`` the rows whose BN
        statistics count in training; ``inverse`` the strided conv's
        (packed inverse rulebook, kernel, stride) for its dX. Returns
        (B, O, Cout)."""
        dt = dtype or self.dtype
        taps = self.weight.permute(2, 3, 4, 1, 0).flatten(0, 2)
        y = _conv(x, packed, taps, self.stride == (1, 1, 1), dt, inverse)
        return self._epilogue(y.to(dt), valid, dtype)

    def forward(self, x, occ_out, dtype=None):
        """The dense twin: NDHWC ``x`` zero off its active sites, the
        output's active sites ``occ_out`` (B, D, H, W)."""
        dt = dtype or self.dtype
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt),
                     stride=self.stride, padding=self.padding)
        y = self._epilogue(y.permute(0, 2, 3, 4, 1), occ_out, dtype)
        return y * occ_out[..., None].to(y.dtype)


class DenseBasicBlock(nn.Module):
    """Dense-tail residual block: two biased DenseConvBNs, then relu(x + y)
    in the activation dtype (bf16 when serving bf16). ``rows`` runs it on
    one submanifold rulebook of the active rows; ``forward`` is its dense
    twin, re-masked by the occupancy. Port of
    det3d_tpu/models/backbones.py::DenseBasicBlock."""

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

    def rows(self, x, packed, dtype=None, valid=None):
        y = self.DenseConvBN_0.rows(x, packed, dtype, valid)
        y = self.DenseConvBN_1.rows(y, packed, dtype, valid)
        return torch.relu(x + y)

    def forward(self, x, occ, dtype=None):
        y = self.DenseConvBN_0(x, occ, dtype)
        y = self.DenseConvBN_1(y, occ, dtype)
        return torch.relu(x + y) * occ[..., None].to(x.dtype)


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

    Rows go into rank order at every stage, as the host plan emits them,
    also at one that builds no lookup (the dense tail's transition, whose
    lookup the tail builds from these rows; a last z conv), where the JAX
    package's evaluation keeps conv_out_coords' zyx order. Returns
    (coords, (r0, pres) down, (r0, pres) subm or None, out shape, bitmap or
    None, packed inverse or None)."""
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


class _RowsTail:
    """The dense tail on its active rows, the rulebooks built on the
    device as it goes, with the functions ``_stage_rulebooks`` calls.

    It starts from the transition's rows (features, coords in rank order,
    shape): their lookup and submanifold rulebook. ``down`` runs a strided
    layer to the next resolution, whose outputs are all kept, as the
    dense tail keeps them: a sample's rows are its whole output grid,
    never the stage cap, the outputs first in rank order and padding after
    (a tile of padding lists no tap). In training each strided layer takes
    its inverse rulebook. The rows go to the BEV map at the end
    (``bev``)."""

    def __init__(self, x, co, shape, dt, training):
        self.x, self.co, self.shape = x, co, shape
        self.dt, self.training = dt, training
        self.lookup = sp.rank_lookup(co, shape)
        self.valid = _valid(co, training)
        self.subm = _pack(sp.subm_window_rulebook_batch(co, shape, 3,
                                                        self.lookup))

    def blocks(self, layers):
        """Submanifold layers (DenseConvBN or DenseBasicBlock), in turn."""
        for layer in layers:
            self.x = layer.rows(self.x, self.subm, self.dt, self.valid)

    def down(self, layer, last=False):
        """The strided ``layer``; ``last``: no layer follows at its output
        resolution, which then needs a lookup only for the inverse."""
        k, s, p = layer.kernel, layer.stride, layer.padding
        cells = math.prod(sp.out_spatial_shape(self.shape, k, s, p))
        co, down, subm, self.shape, self.lookup, inv = _stage_rulebooks(
            self.co, self.shape, k, s, p, cells, self.lookup, not last,
            self.training)
        self.co, self.valid = co, _valid(co, self.training)
        self.x = layer.rows(self.x, _pack(down), self.dt, self.valid,
                            None if inv is None else (inv, k, s))
        self.subm = None if subm is None else _pack(subm)

    def bev(self):
        return _bev_reshape(self.x, self.co, self.shape)


# (channels, n_subm, kernel, stride, padding) per downsample stage
_SPECS = ((32, 2, 3, 2, 1), (64, 3, 3, 2, 1), (64, 3, 3, 2, (0, 1, 1)))


@BACKBONES.register_module
class SpMiddleFHD(nn.Module):
    """SECOND sparse middle. Port of
    det3d_tpu/models/backbones.py::SpMiddleFHD.

    Input: voxel_features (B, V, C), coords (B, V, 3) int32 zyx (-1 pad),
    input_shape (nx, ny, nz), and the host plan (ops/sparse_host.py, keys
    without their ``plan_`` prefix) or None. Output: (B, ny/8, nx/8, 64 *
    D_final). Stages before ``dense_from`` run sparse window convs on the
    plan's rulebooks, under its stage caps; with ``dense_tail`` the rest
    (the JAX package's masked dense conv3d, ``DenseConvBN``) run as window
    convs on every active site, over rulebooks the tail builds on the
    device (``_RowsTail``), host plan or not. From a host plan the middle
    computes in ``serve_precision`` when set, else ``precision``; without
    one it builds the plan on the device (build_plan_device) and computes
    in ``precision``, as the JAX package's ``plan=None`` path does. In
    training (``module.train()``) it computes in ``precision`` from either
    plan (a training plan: host_plan_fn(train=True) or
    build_plan_device(train=True)), the tail in fp32 too, and passes each
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

        for i, (ch, n_subm, k, s, p) in enumerate(_SPECS[:self.start],
                                                  start=1):
            co, down, subm, shape, inv = _plan_stage(plan, i, shape, k, s, p)
            valid = _valid(co, self.training)
            x = next(convs)(x, down, False, dt, valid, inv)
            if i < self.start:
                for _ in range(n_subm):
                    x = next(convs)(x, subm, True, dt, valid)
        if self.start < 4:
            with trace.segment("dense_tail"):
                tail = _RowsTail(x.to(dt or self.dtype), co, shape, dt,
                                 self.training)
                tail.blocks([next(dconvs)
                             for _ in range(_SPECS[self.start - 1][1])])
                for spec in _SPECS[self.start:]:
                    tail.down(next(dconvs))
                    tail.blocks([next(dconvs) for _ in range(spec[1])])
                tail.down(next(dconvs), last=True)
                return tail.bev()
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
    at ``dense_from`` the strided conv, then, in the activation dtype, the
    dense tail: two DenseBasicBlocks; after it a strided DenseConvBN and
    two DenseBasicBlocks; then the (3, 1, 1) z conv to 128 channels, all
    on the active sites as SpMiddleFHD's tail. Without ``dense_tail``
    every stage and the z conv stay sparse. Input, output
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

        for i, (ch, k, s, p) in enumerate(_RES_SPECS[:self.start], start=1):
            co, down, subm, shape, inv = _plan_stage(plan, i, shape, k, s, p)
            valid = _valid(co, self.training)
            x = next(scb)(x, down, False, dt, valid, inv)
            if i < self.start:
                for _ in range(2):
                    x = next(mods["SparseBasicBlock"])(x, subm, dt, valid)
        if self.start < 4:
            with trace.segment("dense_tail"):
                blocks = mods["DenseBasicBlock"]
                tail = _RowsTail(x.to(dt or self.dtype), co, shape, dt,
                                 self.training)
                tail.blocks([next(blocks) for _ in range(2)])
                for _ in _RES_SPECS[self.start:]:
                    tail.down(next(dcb))
                    tail.blocks([next(blocks) for _ in range(2)])
                tail.down(next(dcb), last=True)
                return tail.bev()
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
