"""Plain PyTorch reference of the VoxelNet family (SECOND, CBGS): points ->
voxel means -> sparse middle -> RPN -> multi-group head, the decode, the
anchor targets, the losses and one Adam step, from a config dict alone.

It imports nothing of the measured program. It works out the voxels, the
active sites of every resolution and each conv's (output, tap, input)
pairs itself, with sorted keys and ``torch.searchsorted``, and computes
each sparse conv as a sum over taps of gathered rows times the tap's
weight. The dense tail of the configs is the same submanifold / strided
sparse conv over the active sites (a masked dense conv3d is that), so
one path serves both. Parameters are a flat dict of tensors under the
names of the model's state dict, which the benchmark makes from the seed
and hands to both sides.

Semantics taken from the configuration (and from the published Det3D
model they describe):

- voxels: ``floor((p - range_min) / voxel_size)`` in fp32; each voxel
  keeps its first ``max_points_in_voxel`` points in input order and its
  feature is their mean. Under the voxel cap the kept voxels are, for
  ``order="yxz"``, those of smallest ``(y * gx + x) * gz + z``, else those
  of smallest murmur3-finalizer hash of the id ``x + gx * (y + gy * z)``
  (the deterministic pseudo-random subset of a hashed voxelizer).
- the grid is ``(gz + 1, gy, gx)`` deep, as spconv's SECOND input shape.
- a strided conv's outputs are every site whose window covers an active
  input; a stage of the sparse part keeps at most ``max_voxel_num`` of
  them, the lowest in zyx-linear order. The dense tail keeps them all.
- BN: eval on the running statistics; training on the batch statistics
  of the active sites (all positions in the RPN), ``var = E[x^2] -
  mean^2``; eps from the config (running statistics are not updated:
  nothing compared reads them).
- weights: a sparse conv's are (kvol, Cin, Cout) with tap
  ``(kz * ky_n + ky) * kx_n + kx`` reading input ``o * stride - pad + k``;
  a dense one's (Cout, Cin, kz, ky, kx), the same taps.

``dtype`` runs every conv and product in that type (operands cast, fp32
out), the rest in fp32: bf16 is the control of the fp32 configs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def grid_size(cfg) -> Tuple[int, int, int]:
    vg = cfg["voxel_generator"]
    vs = np.asarray(vg["voxel_size"], np.float64)
    rng = np.asarray(vg["range"], np.float64)
    return tuple(int(v) for v in np.round((rng[3:] - rng[:3]) / vs))


def _as3(v):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * 3


class Arch:
    """The layers of a config's model, in call order, with their names."""

    def __init__(self, cfg):
        self.cfg = cfg
        m = cfg["model"]
        self.bb = m["backbone"]
        self.neck = m["neck"]
        self.head = m["bbox_head"]
        self.kind = self.bb["type"]
        if self.kind not in ("SpMiddleFHD", "SpMiddleResNetFHD"):
            raise NotImplementedError(f"reference middle {self.kind}")
        self.gx, self.gy, self.gz = grid_size(cfg)
        self.cap = int(cfg["voxel_generator"].get("max_voxel_num", 20000))
        self.cin = int(m["reader"].get("num_input_features", 4))
        nc = self.bb.get("norm_cfg") or {}
        self.eps = float(nc.get("eps", 1e-3))
        self.dense_from = int(self.bb.get("dense_from", 3))
        self.tasks = cfg["tasks"]
        self.num_classes = [len(t["class_names"]) for t in self.tasks]
        bc = self.head["box_coder"]
        self.nd = int(bc.get("n_dim", 7))
        self.vec = bool(bc.get("encode_angle_vector", False))
        self.code = self.nd + 1 if self.vec else self.nd
        self.use_dir = self.head.get("loss_aux") is not None
        self.middle = self._middle()

    # each middle op: (kind, name, cin, cout, kernel, stride, pad, opts)
    def _middle(self):
        ops = []
        if self.kind == "SpMiddleFHD":
            n = [0, 0]

            def conv(cin, cout, k=3, s=1, p=1, dense=False, new=False):
                key = "DenseConvBN" if dense else "SparseConvBN"
                i = n[dense]
                n[dense] += 1
                ops.append(dict(op="conv", name=f"backbone.{key}_{i}",
                                cin=cin, cout=cout, k=_as3(k), s=_as3(s),
                                p=_as3(p), dense=dense, new=new,
                                bias=False, relu=True))
            conv(self.cin, 16)
            conv(16, 16)
            cin = 16
            specs = ((32, 2, 3, 2, 1), (64, 3, 3, 2, 1),
                     (64, 3, 3, 2, (0, 1, 1)))
            start = self.dense_from
            for i, (ch, n_subm, k, s, p) in enumerate(specs, start=1):
                conv(cin, ch, k, s, p, dense=i > start, new=True)
                for _ in range(n_subm):
                    conv(ch, ch, dense=i >= start)
                cin = ch
            conv(64, 64, (3, 1, 1), (2, 1, 1), 0, dense=start < 4, new=True)
            return ops
        counts: Dict[str, int] = {}

        def name(cls):
            i = counts.get(cls, 0)
            counts[cls] = i + 1
            return f"backbone.{cls}_{i}"

        def conv(nm, cin, cout, k=3, s=1, p=1, dense=False, new=False,
                 bias=False, relu=True):
            ops.append(dict(op="conv", name=nm, cin=cin, cout=cout,
                            k=_as3(k), s=_as3(s), p=_as3(p), dense=dense,
                            new=new, bias=bias, relu=relu))

        def blocks(ch, dense):
            for _ in range(2):
                cls = "DenseBasicBlock" if dense else "SparseBasicBlock"
                sub = "DenseConvBN" if dense else "SparseConvBN"
                nm = name(cls)
                ops.append(dict(op="save"))
                conv(f"{nm}.{sub}_0", ch, ch, dense=dense, bias=True)
                conv(f"{nm}.{sub}_1", ch, ch, dense=dense, bias=True,
                     relu=False)
                ops.append(dict(op="residual"))

        start = self.dense_from
        conv(name("SparseConvBN"), self.cin, 16)
        blocks(16, False)
        cin = 16
        for i, (ch, k, s, p) in enumerate(((32, 3, 2, 1), (64, 3, 2, 1),
                                           (128, 3, 2, (0, 1, 1))), start=1):
            dense = i > start
            conv(name("DenseConvBN" if dense else "SparseConvBN"), cin, ch,
                 k, s, p, dense=dense, new=True)
            blocks(ch, i >= start)
            cin = ch
        conv(name("DenseConvBN" if start < 4 else "SparseConvBN"), 128, 128,
             (3, 1, 1), (2, 1, 1), 0, dense=start < 4, new=True)
        return ops

    # -- the parameters ---------------------------------------------------
    def param_spec(self) -> List[Tuple[str, tuple, str, int]]:
        """(name, shape, kind, fan_in): kind "w" (a conv or linear weight,
        random), "b" (a bias, zero), "scale" (BN, one), "shift" (BN,
        zero), "mean" / "var" (BN statistics, calibrated)."""
        out = []

        def bn(prefix, c):
            out.extend([(f"{prefix}.scale", (c,), "scale", 0),
                        (f"{prefix}.bias", (c,), "shift", 0),
                        (f"{prefix}.mean", (c,), "mean", 0),
                        (f"{prefix}.var", (c,), "var", 0)])

        for o in self.middle:
            if o["op"] != "conv":
                continue
            kv = o["k"][0] * o["k"][1] * o["k"][2]
            if o["dense"]:
                shape = (o["cout"], o["cin"]) + o["k"]
            else:
                shape = (kv, o["cin"], o["cout"])
            out.append((f"{o['name']}.weight", shape, "w", kv * o["cin"]))
            if o["bias"]:
                out.append((f"{o['name']}.bias", (o["cout"],), "b", 0))
            bn(f"{o['name']}.norm", o["cout"])
        for name, conv, cin, cout, k, bn_name in self.neck_layers():
            shape = (cin, cout, k, k) if conv == "deconv" else (cout, cin,
                                                                k, k)
            out.append((f"neck.{name}.weight", shape, "w", cin * k * k))
            bn(f"neck.{bn_name}", cout)
        for t, (nm, cin, cout) in enumerate(self.head_layers()):
            out.append((f"bbox_head.{nm}.weight", (cout, cin, 1, 1), "w",
                        cin))
            out.append((f"bbox_head.{nm}.bias", (cout,), "b", 0))
        return out

    def neck_layers(self):
        """(name, conv|deconv, cin, cout, kernel, bn name) in call order,
        with ("branch", ...) entries after a stage's convs."""
        n = self.neck
        layer_nums = n["layer_nums"]
        us_strides = n["us_layer_strides"]
        us_start = len(layer_nums) - len(us_strides)
        out = []
        cin = n["num_input_features"]
        for i, nb in enumerate(layer_nums):
            cout = n["ds_num_filters"][i]
            for j in range(nb + 1):
                nm = f"block{i}_down" if j == 0 else f"block{i}_conv{j - 1}"
                out.append((f"{nm}_conv", "conv", cin if j == 0 else cout,
                            cout, 3, f"{nm}_bn"))
            k = i - us_start
            if k >= 0:
                s = us_strides[k]
                if s > 1:
                    out.append((f"deblock{k}_deconv", "deconv", cout,
                                n["us_num_filters"][k], int(s),
                                f"deblock{k}_bn"))
                else:
                    out.append((f"deblock{k}_conv", "conv", cout,
                                n["us_num_filters"][k],
                                int(round(1 / s)), f"deblock{k}_bn"))
            cin = cout
        return out

    def head_layers(self):
        cin = self.head["in_channels"]
        out = []
        for t, nc in enumerate(self.num_classes):
            a = 2 * nc
            out.append((f"task_{t}.conv_box", cin, a * self.code))
            out.append((f"task_{t}.conv_cls", cin, a * nc))
            if self.use_dir:
                out.append((f"task_{t}.conv_dir", cin, a * 2))
        return out


# ---------------------------------------------------------------------------
# voxels and active sites
# ---------------------------------------------------------------------------

def _mix32(x):
    x = x & _U32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _U32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _U32
    return x ^ (x >> 16)


class Sites:
    """The active sites of one resolution over a batch: ``coords`` (N, 4)
    int64 [b, z, y, x], sorted by ``keys`` = ((b * D + z) * H + y) * W +
    x (so each sample's rows run in zyx-linear order)."""

    def __init__(self, coords, shape, batch):
        self.shape = tuple(int(s) for s in shape)
        self.batch = int(batch)
        keys = self.key_of(coords)
        keys, order = torch.sort(keys)
        self.keys = keys
        self.coords = coords[order]
        self.order = order

    def key_of(self, c):
        d, h, w = self.shape
        return ((c[:, 0] * d + c[:, 1]) * h + c[:, 2]) * w + c[:, 3]

    def __len__(self):
        return int(self.keys.shape[0])

    def find(self, c, ok):
        """Rows of sites ``c`` (M, 4) where ``ok``; len(self) where absent."""
        n = len(self)
        q = torch.where(ok, self.key_of(torch.where(ok[:, None], c, 0)), -1)
        i = torch.searchsorted(self.keys, q).clamp(max=max(n - 1, 0))
        hit = ok & (n > 0)
        if n:
            hit = hit & (self.keys[i] == q)
        return torch.where(hit, i, n)


def voxelize(points, num_points, cfg):
    """(B, P, C) points and (B,) counts -> (Sites, (N, C) fp32 means).
    The rows come in the Sites' order."""
    vg = cfg["voxel_generator"]
    gx, gy, gz = grid_size(cfg)
    tcap = int(vg.get("max_points_in_voxel", 100))
    vcap = int(vg.get("max_voxel_num", 20000))
    yxz = vg.get("order", "appearance") == "yxz"
    dev = points.device
    b, p, c = points.shape
    vsize = torch.tensor(vg["voxel_size"], dtype=torch.float32, device=dev)
    vmin = torch.tensor(vg["range"][:3], dtype=torch.float32, device=dev)
    coords_all, feats_all = [], []
    for i in range(b):
        n = int(num_points[i])
        pts = points[i, :n].float()
        q = torch.floor((pts[:, :3] - vmin) / vsize).long()
        ok = ((q[:, 0] >= 0) & (q[:, 0] < gx) & (q[:, 1] >= 0)
              & (q[:, 1] < gy) & (q[:, 2] >= 0) & (q[:, 2] < gz))
        pts, q = pts[ok], q[ok]
        lin = q[:, 0] + q[:, 1] * gx + q[:, 2] * (gx * gy)
        # points grouped by voxel, in input order within a voxel
        lin_s, perm = torch.sort(lin, stable=True)
        uniq, inv, counts = torch.unique_consecutive(
            lin_s, return_inverse=True, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(lin_s.shape[0], device=dev) - starts[inv]
        # the kept voxels under the cap
        if yxz:
            x, y, z = uniq % gx, (uniq // gx) % gy, uniq // (gx * gy)
            rank_key = (y * gx + x) * gz + z
        else:
            rank_key = _mix32(uniq)
        keep_v = torch.zeros_like(uniq, dtype=torch.bool)
        keep_v[torch.argsort(rank_key)[:vcap]] = True
        sums = torch.zeros(uniq.shape[0], c, dtype=torch.float32,
                           device=dev)
        src = pts[perm]
        for t in range(tcap):
            at = slot == t
            sums[inv[at]] = sums[inv[at]] + src[at]
        cnt = torch.clamp(counts, max=tcap).to(torch.float32)
        means = (sums / cnt[:, None])[keep_v]
        u = uniq[keep_v]
        coords = torch.stack([torch.full_like(u, i), u // (gx * gy),
                              (u // gx) % gy, u % gx], -1)
        coords_all.append(coords)
        feats_all.append(means)
    arch_shape = (gz + 1, gy, gx)
    sites = Sites(torch.cat(coords_all), arch_shape, b)
    return sites, torch.cat(feats_all)[sites.order]


def out_shape(shape, k, s, p):
    return tuple((shape[d] + 2 * p[d] - k[d]) // s[d] + 1 for d in range(3))


def taps(k):
    kz, ky, kx = k
    return [(a, b_, c) for a in range(kz) for b_ in range(ky)
            for c in range(kx)]


def strided_sites(sites: Sites, k, s, p, cap: Optional[int]) -> Sites:
    """The outputs of a strided conv over ``sites``: every in-range site
    whose window covers an active input, at most ``cap`` a sample, the
    lowest in zyx-linear order."""
    oshape = out_shape(sites.shape, k, s, p)
    c = sites.coords
    cands = []
    for t in taps(k):
        num = c[:, 1:] + torch.tensor(p, device=c.device) - torch.tensor(
            t, device=c.device)
        sv = torch.tensor(s, device=c.device)
        o = torch.div(num, sv, rounding_mode="floor")
        ok = (num % sv == 0).all(1)
        for d in range(3):
            ok &= (o[:, d] >= 0) & (o[:, d] < oshape[d])
        cands.append(torch.cat([c[ok, :1], o[ok]], 1))
    allc = torch.cat(cands)
    tmp = Sites(allc, oshape, sites.batch)
    keys = torch.unique(tmp.keys)
    d, h, w = oshape
    coords = torch.stack([keys // (d * h * w), (keys // (h * w)) % d,
                          (keys // w) % h, keys % w], -1)
    if cap is not None:
        # keys are sorted: each sample's rows are contiguous, zyx-linear
        first = torch.searchsorted(keys, coords[:, 0] * (d * h * w))
        rank = torch.arange(keys.shape[0], device=keys.device) - first
        coords = coords[rank < cap]
    return Sites(coords, oshape, sites.batch)


def pairs_of(sin: Sites, sout: Sites, k, s, p):
    """(idx (T, M) rows of ``sin`` per tap and output, len(sin) where the
    tap reads none; the number of (output, tap) pairs that read one)."""
    oc = sout.coords
    dev = oc.device
    rows = []
    for t in taps(k):
        q = torch.cat([oc[:, :1], oc[:, 1:] * torch.tensor(s, device=dev)
                       - torch.tensor(p, device=dev)
                       + torch.tensor(t, device=dev)], 1)
        ok = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
        for d in range(3):
            ok &= (q[:, d + 1] >= 0) & (q[:, d + 1] < sin.shape[d])
        rows.append(sin.find(q, ok))
    idx = torch.stack(rows)
    return idx, int((idx < len(sin)).sum())


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def _mm(x, w, dtype):
    if dtype == torch.float32:
        return x @ w
    return (x.to(dtype) @ w.to(dtype)).float()


def _conv_dt(fn, x, w, dtype, **kw):
    if dtype == torch.float32:
        return fn(x, w, **kw)
    return fn(x.to(dtype), w.to(dtype), **kw).float()


class Ctx:
    """One forward's settings and what it records: the BN mode
    ("eval", "train", "calib"), the product dtype, and the work
    (``work``: per layer (name, kind, pairs, rows_in, rows_out, cin,
    cout, flops))."""

    def __init__(self, P, mode="eval", dtype=torch.float32, eps=1e-3):
        self.P, self.mode, self.dtype, self.eps = P, mode, dtype, eps
        self.work: List[dict] = []

    def bn(self, x, name):
        """BN over the last axis of x (rows are the active sites or all
        positions)."""
        P = self.P
        xf = x.float().reshape(-1, x.shape[-1])
        if self.mode == "train":
            cnt = max(xf.shape[0], 1)
            mean = xf.sum(0) / cnt
            var = torch.clamp((xf * xf).sum(0) / cnt - mean * mean, min=0.0)
        elif self.mode == "calib":
            live = xf[xf.abs().sum(1) > 0]
            live = live if live.shape[0] > 1 else xf
            with torch.no_grad():
                P[f"{name}.mean"].copy_(live.mean(0))
                P[f"{name}.var"].copy_(live.var(0, unbiased=False))
            mean, var = P[f"{name}.mean"], P[f"{name}.var"]
        else:
            mean, var = P[f"{name}.mean"], P[f"{name}.var"]
        inv = torch.rsqrt(var + self.eps) * P[f"{name}.scale"]
        return ((x.float() - mean) * inv + P[f"{name}.bias"])


def _tap_weight(w, t, ti, dense_w):
    return w[:, :, t[0], t[1], t[2]].t() if dense_w else w[ti]


class _GatherConv(torch.autograd.Function):
    """out[o] = sum over taps t of x[idx[t, o]] @ W[t] (a row past the end
    of x reads zero). The backward gathers again and scatters dX by
    ``index_add_``, so only x, W and the indices are kept: the gathered
    copies of every tap would not fit at CBGS's training size."""

    @staticmethod
    def forward(ctx, x, w, idx, k, dense_w, dtype):
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        cout = w.shape[0] if dense_w else w.shape[-1]
        out = x.new_zeros(idx.shape[1], cout)
        for ti, t in enumerate(taps(k)):
            out = out + _mm(xp[idx[ti]], _tap_weight(w, t, ti, dense_w),
                            dtype)
        ctx.save_for_backward(x, w, idx)
        ctx.k, ctx.dense_w, ctx.dtype = k, dense_w, dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, idx = ctx.saved_tensors
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        dxp = torch.zeros_like(xp)
        dw = torch.zeros_like(w)
        for ti, t in enumerate(taps(ctx.k)):
            sel = idx[ti]
            g = _mm(xp[sel].t(), dy, ctx.dtype)              # (Cin, Cout)
            if ctx.dense_w:
                dw[:, :, t[0], t[1], t[2]] = g.t()
            else:
                dw[ti] = g
            dxp.index_add_(0, sel, _mm(
                dy, _tap_weight(w, t, ti, ctx.dense_w).t(), ctx.dtype))
        return dxp[:-1], dw, None, None, None, None


def sparse_conv(ctx, x, sin, sout, w, k, s, p, name, dense_w=False):
    """The conv of ``w`` from the sites ``sin`` to ``sout``; records its
    work in ctx. ``dense_w``: w is (Cout, Cin, kz, ky, kx)."""
    idx, npairs = pairs_of(sin, sout, k, s, p)
    out = _GatherConv.apply(x, w, idx, tuple(k), dense_w, ctx.dtype)
    cin, cout = x.shape[1], out.shape[1]
    ctx.work.append(dict(name=name, kind="dense" if dense_w else "sparse",
                         subm=sin is sout, pairs=npairs, rows_in=len(sin),
                         rows_out=len(sout), cin=cin, cout=cout,
                         kvol=len(taps(k)),
                         flops=2.0 * cin * cout * npairs))
    return out


def middle(ctx, arch: Arch, sites: Sites, x):
    """The sparse middle: (BEV map (B, H, W, C * D) fp32, per-stage Sites)."""
    P = ctx.P
    cap = arch.cap
    cur = sites
    saved = None
    stages = [sites]
    for o in arch.middle:
        if o["op"] == "save":
            saved = x
            continue
        if o["op"] == "residual":
            x = torch.relu(saved + x)
            continue
        k, s, p = o["k"], o["s"], o["p"]
        if o["new"]:
            nxt = strided_sites(cur, k, s, p,
                                None if o["dense"] else cap)
            stages.append(nxt)
        else:
            nxt = cur
        y = sparse_conv(ctx, x, cur, nxt, P[f"{o['name']}.weight"], k, s, p,
                        o["name"], dense_w=o["dense"])
        if o["bias"]:
            y = y + P[f"{o['name']}.bias"]
        y = ctx.bn(y, f"{o['name']}.norm")
        x = torch.relu(y) if o["relu"] else y
        cur = nxt
    # fold depth: (B, H, W, C * D), channel-major
    d, h, w = cur.shape
    c = x.shape[1]
    dense = x.new_zeros(cur.batch, h, w, c, d)
    cc = cur.coords
    dense[cc[:, 0], cc[:, 2], cc[:, 3], :, cc[:, 1]] = x
    return dense.reshape(cur.batch, h, w, c * d), stages


def rpn(ctx, arch: Arch, x):
    """(B, H, W, C) -> (B, H', W', C') over the neck's layers."""
    P = ctx.P
    n = arch.neck
    x = x.permute(0, 3, 1, 2)
    ups = []
    layers = arch.neck_layers()
    i = 0
    for si, nb in enumerate(n["layer_nums"]):
        for j in range(nb + 1):
            name, _, cin, cout, k, bn = layers[i]
            i += 1
            stride = n["ds_layer_strides"][si] if j == 0 else 1
            w = P[f"neck.{name}.weight"]
            x = _conv_dt(F.conv2d, x, w, ctx.dtype, stride=stride, padding=1)
            _count2d(ctx, f"neck.{name}", cin, cout, k, x.shape)
            x = torch.relu(ctx.bn(x.permute(0, 2, 3, 1), f"neck.{bn}")
                           ).permute(0, 3, 1, 2)
        if i < len(layers) and layers[i][0].startswith("deblock"):
            name, kind, cin, cout, k, bn = layers[i]
            i += 1
            w = P[f"neck.{name}.weight"]
            if kind == "deconv":
                y = _conv_dt(F.conv_transpose2d, x, w, ctx.dtype, stride=k)
                _count2d(ctx, f"neck.{name}", cin, cout, k, x.shape)
            else:
                y = _conv_dt(F.conv2d, x, w, ctx.dtype, stride=k)
                _count2d(ctx, f"neck.{name}", cin, cout, k, y.shape)
            ups.append(torch.relu(ctx.bn(y.permute(0, 2, 3, 1),
                                         f"neck.{bn}")).permute(0, 3, 1, 2))
    if ups:
        x = torch.cat(ups, 1)
    return x.permute(0, 2, 3, 1)


def _count2d(ctx, name, cin, cout, k, shape):
    """A dense 2-D conv's products: 2 Cin Cout k^2 per position of the
    map ``shape`` counts over (the output; a deconv's input)."""
    b, _, h, w = shape
    ctx.work.append(dict(name=name, kind="conv2d", pairs=b * h * w * k * k,
                         cin=cin, cout=cout,
                         flops=2.0 * cin * cout * k * k * b * h * w))


def head(ctx, arch: Arch, x):
    """(B, H, W, C) -> per task {box_preds, cls_preds[, dir_cls_preds]},
    NHWC fp32."""
    P = ctx.P
    xc = x.permute(0, 3, 1, 2)
    outs = []
    b, h, w, cin = x.shape
    for t in range(len(arch.tasks)):
        d = {}
        for key, nm in (("box_preds", "conv_box"), ("cls_preds", "conv_cls"),
                        ("dir_cls_preds", "conv_dir")):
            pre = f"bbox_head.task_{t}.{nm}"
            if f"{pre}.weight" not in P:
                continue
            wgt = P[f"{pre}.weight"]
            y = _conv_dt(F.conv2d, xc, wgt, ctx.dtype) + P[f"{pre}.bias"][
                :, None, None]
            ctx.work.append(dict(name=pre, kind="conv2d", pairs=b * h * w,
                                 cin=cin, cout=wgt.shape[0],
                                 flops=2.0 * cin * wgt.shape[0] * b * h * w))
            d[key] = y.permute(0, 2, 3, 1)
        outs.append(d)
    return outs


def forward(arch: Arch, P, points, num_points, mode="eval",
            dtype=torch.float32):
    """Points -> (per-task head outputs, Ctx with the work, the res0
    Sites)."""
    ctx = Ctx(P, mode, dtype, arch.eps)
    sites, feats = voxelize(points, num_points, arch.cfg)
    x, stages = middle(ctx, arch, sites, feats)
    x = rpn(ctx, arch, x)
    return head(ctx, arch, x), ctx, stages


# ---------------------------------------------------------------------------
# anchors, decode, targets, losses
# ---------------------------------------------------------------------------

def feature_map(arch: Arch):
    osf = int(arch.cfg["assigner"]["out_size_factor"])
    return [1, arch.gy // osf, arch.gx // osf]


def _class_anchors(gen, fm):
    """One anchor_generator_range's anchors (H * W * rots, nd), float32."""
    rng = np.asarray(gen["anchor_ranges"], np.float32)
    stride = (rng[3] - rng[0]) / fm[2]
    zc = np.linspace(rng[2], rng[5], fm[0], dtype=np.float32)
    yc = np.linspace(rng[1], rng[4], fm[1], endpoint=False,
                     dtype=np.float32) + stride / 2
    xc = np.linspace(rng[0], rng[3], fm[2], endpoint=False,
                     dtype=np.float32) + stride / 2
    rots = np.asarray(gen.get("rotations", [0, np.pi / 2]), np.float32)
    size = np.asarray(gen["sizes"], np.float32).reshape(3)
    vel = gen.get("velocities")
    extra = np.concatenate([size, np.asarray(vel, np.float32)]) \
        if vel is not None else size
    # (z, y, x, rot) grid; rows [x, y, z, sizes.., (vel..), rot]
    z, y, x, r = np.meshgrid(zc, yc, xc, rots, indexing="ij")
    shape = z.shape
    cols = [x, y, z] + [np.full(shape, e, np.float32) for e in extra] + [r]
    return np.stack(cols, -1).reshape(-1, len(cols)).astype(np.float32)


def task_anchors(arch: Arch, device):
    """Per task: (anchors (A, nd), per-class anchors list), the task's
    classes concatenated per location."""
    fm = feature_map(arch)
    gens = arch.cfg["assigner"]["target_assigner"]["anchor_generators"]
    out, gi = [], 0
    for nc in arch.num_classes:
        per = [_class_anchors(g, fm) for g in gens[gi:gi + nc]]
        gi += nc
        nloc = len(arch.cfg["assigner"]["target_assigner"][
            "anchor_generators"][0].get("rotations", [0, 1]))
        hw = fm[1] * fm[2]
        full = np.concatenate([a.reshape(hw, nloc, -1) for a in per], 1)
        out.append((torch.as_tensor(full.reshape(-1, full.shape[-1]),
                                    device=device),
                    [torch.as_tensor(a, device=device) for a in per]))
    return out


def decode(arch: Arch, enc, anchors):
    nd = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    ra = anchors[..., nd - 1]
    diag = torch.sqrt(la ** 2 + wa ** 2)
    cols = [enc[..., 0] * diag + xa, enc[..., 1] * diag + ya,
            enc[..., 2] * ha + za, torch.exp(enc[..., 3]) * wa,
            torch.exp(enc[..., 4]) * la, torch.exp(enc[..., 5]) * ha]
    off = 6
    if nd > 7:
        cols += [enc[..., 6] + anchors[..., 6], enc[..., 7] + anchors[..., 7]]
        off = 8
    if arch.vec:
        cols.append(torch.atan2(enc[..., off + 1] + torch.sin(ra),
                                enc[..., off] + torch.cos(ra)))
    else:
        cols.append(enc[..., off] + ra)
    return torch.stack(cols, -1)


def encode(arch: Arch, boxes, anchors):
    nd = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    ra = anchors[..., nd - 1]
    xg, yg, zg, wg, lg, hg = (boxes[..., i] for i in range(6))
    rg = boxes[..., nd - 1]
    diag = torch.sqrt(la ** 2 + wa ** 2)
    cols = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
            torch.log(wg / wa), torch.log(lg / la), torch.log(hg / ha)]
    if nd > 7:
        cols += [boxes[..., 6] - anchors[..., 6],
                 boxes[..., 7] - anchors[..., 7]]
    if arch.vec:
        cols += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
    else:
        cols.append(rg - ra)
    return torch.stack(cols, -1)


def _near_bbox(b5):
    """[x, y, w, l, r] -> the nearest axis-aligned [x1, y1, x2, y2]."""
    r = b5[..., 4]
    rp = torch.abs(r - torch.floor(r / math.pi + 0.5) * math.pi)
    swap = (rp > math.pi / 4)[..., None]
    wl = torch.where(swap, b5[..., [3, 2]], b5[..., 2:4])
    return torch.cat([b5[..., :2] - wl / 2, b5[..., :2] + wl / 2], -1)


def _iou_aligned(a, g):
    lt = torch.maximum(a[..., :, None, :2], g[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], g[..., None, :, 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    ag = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    union = aa[..., :, None] + ag[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       0.0)


def _bev(b):
    return torch.cat([b[..., 0:2], b[..., 3:5], b[..., -1:]], -1)


def targets(arch: Arch, anchors_t, gt_boxes, gt_classes, gt_valid):
    """Per task (labels (B, A), reg targets (B, A, code)): nearest-IoU
    similarity, the config's thresholds, force matches."""
    gens = arch.cfg["assigner"]["target_assigner"]["anchor_generators"]
    b = gt_boxes.shape[0]
    out, gi, cid = [], 0, 1
    fm = feature_map(arch)
    hw = fm[1] * fm[2]
    for t, nc in enumerate(arch.num_classes):
        labs, tars = [], []
        for c in range(nc):
            g = gens[gi + c]
            anc = anchors_t[t][1][c]
            mt = float(g.get("matched_threshold", -1))
            ut = float(g.get("unmatched_threshold", -1))
            valid = gt_valid & (gt_classes == cid + c)
            sim = _iou_aligned(_near_bbox(_bev(anc))[None].expand(b, -1, -1),
                               _near_bbox(_bev(gt_boxes)))
            sim = torch.where(valid[:, None, :], sim, -1.0)
            amax, arg = sim.max(2)
            gmax = sim.amax(1)
            elig = valid & (gmax > 0)
            force = ((sim == gmax[:, None, :]) & elig[:, None, :]).any(2)
            cls = torch.gather(gt_classes.long(), 1, arg)
            fg0 = force | (amax >= mt)
            lab = torch.where(fg0, cls, torch.where(amax < ut, 0, -1))
            lab = torch.where(valid.any(1, keepdim=True), lab, 0)
            safe = torch.cat([gt_boxes[..., :3],
                              torch.clamp(gt_boxes[..., 3:6], min=1e-3),
                              gt_boxes[..., 6:]], -1)
            matched = torch.gather(safe, 1, arg[..., None].expand(
                -1, -1, safe.shape[-1]))
            enc = encode(arch, matched, anc[None].expand(b, -1, -1))
            tar = torch.where((lab > 0)[..., None], enc, 0.0)
            nloc = anc.shape[0] // hw
            labs.append(lab.reshape(b, hw, nloc))
            tars.append(tar.reshape(b, hw, nloc, -1))
        gi += nc
        cid += nc
        out.append((torch.cat(labs, 2).reshape(b, -1),
                    torch.cat(tars, 2).reshape(b, hw * sum(
                        x.shape[2] for x in labs), -1)))
    return out


def loss(arch: Arch, preds, tgts, anchors_t):
    """The total loss over tasks (fp32 0-d) and per-task parts."""
    hd = arch.head
    ln = hd.get("loss_norm", {})
    pos_w = float(ln.get("pos_cls_weight", 1.0))
    neg_w = float(ln.get("neg_cls_weight", 1.0))
    lc, lb, la = hd["loss_cls"], hd["loss_bbox"], hd.get("loss_aux")
    sigma = float(lb.get("sigma", 3.0))
    alpha, gamma = float(lc.get("alpha", 0.25)), float(lc.get("gamma", 2.0))
    by_sin = bool(hd.get("encode_rad_error_by_sin", True))
    total = 0.0
    parts = []
    for t, (pr, (labels, reg_t)) in enumerate(zip(preds, tgts)):
        b = labels.shape[0]
        nc = arch.num_classes[t]
        pos = labels > 0
        neg = labels == 0
        cared = labels >= 0
        posn = torch.clamp(pos.sum(1, keepdim=True).float(), min=1.0)
        cls_w = (neg.float() * neg_w + pos.float() * pos_w) / posn
        reg_w = pos.float() / posn
        cls_tgt = labels * cared.long()
        box = pr["box_preds"].reshape(b, -1, arch.code)
        cls = pr["cls_preds"].reshape(b, -1, nc)
        onehot = (cls_tgt[..., None] == torch.arange(
            nc + 1, device=labels.device)).float()[..., 1:]
        if by_sin:
            rp = torch.sin(box[..., -1:]) * torch.cos(reg_t[..., -1:])
            rt = torch.cos(box[..., -1:]) * torch.sin(reg_t[..., -1:])
            box = torch.cat([box[..., :-1], rp], -1)
            reg_t = torch.cat([reg_t[..., :-1], rt], -1)
        diff = torch.abs(box - reg_t)
        k = 1.0 / sigma ** 2
        lt = (diff <= k).float()
        loc = (lt * 0.5 * (diff * sigma) ** 2 + (diff - 0.5 * k) * (1 - lt))
        loc = loc * reg_w[..., None]
        ce = (torch.clamp(cls, min=0) - cls * onehot
              + torch.log1p(torch.exp(-torch.abs(cls))))
        p = torch.sigmoid(cls)
        p_t = onehot * p + (1 - onehot) * (1 - p)
        focal = torch.pow(1 - p_t, gamma) * (onehot * alpha + (1 - onehot)
                                             * (1 - alpha)) * ce
        focal = focal * cls_w[..., None]
        loc_r = loc.sum() / b * float(lb.get("loss_weight", 1.0))
        cls_r = focal.sum() / b * float(lc.get("loss_weight", 1.0))
        lt_ = loc_r + cls_r
        if la is not None:
            anc = anchors_t[t][0][None].expand(b, -1, -1)
            # the target's yaw, from the targets before the sine encoding
            rot = tgts[t][1][..., -1] + anc[..., -1]
            period = 2 * math.pi
            off = float(hd.get("direction_offset", 0.0))
            v = rot - off
            dir_cls = ((v - torch.floor(v / period + 0.5) * period) > 0).long()
            dt = (dir_cls[..., None] == torch.arange(
                2, device=labels.device)).float()
            logits = pr["dir_cls_preds"].reshape(b, -1, 2)
            wd = pos.float()
            wd = wd / torch.clamp(wd.sum(-1, keepdim=True), min=1.0)
            dce = -(dt * torch.log_softmax(logits, -1)).sum(-1) * wd
            lt_ = lt_ + dce.sum() / b * float(la.get("loss_weight", 1.0))
        parts.append(lt_)
        total = total + lt_
    return total, parts


# ---------------------------------------------------------------------------
# the optimizer: clip, Adam with the one-cycle schedules, decoupled decay
# ---------------------------------------------------------------------------

def one_cycle(cfg, total_steps):
    lc = cfg["lr_config"]
    lr_max = float(lc["lr_max"])
    div = float(lc.get("div_factor", 10.0))
    pct = float(lc.get("pct_start", 0.4))
    hi_m, lo_m = (float(m) for m in lc.get("moms", (0.95, 0.85)))
    low = lr_max / div
    final = low / 1e4
    a1 = max(int(total_steps * pct), 1)
    a2 = max(total_steps - a1, 1)

    def cos(a, b, p):
        return b + (a - b) / 2.0 * (math.cos(math.pi * p) + 1.0)

    def at(step):
        p1 = min(max(step / a1, 0.0), 1.0)
        p2 = min(max((step - a1) / a2, 0.0), 1.0)
        if step < a1:
            return cos(low, lr_max, p1), cos(hi_m, lo_m, p1)
        return cos(lr_max, final, p2), cos(lo_m, hi_m, p2)
    return at


class Adam:
    """The config's optimizer: global-norm clip, Adam (b2 0.99, eps 1e-8
    outside the root, b1 and lr from the schedules at the count before the
    step), ``wd * p`` added to the direction of every non-BN parameter."""

    def __init__(self, cfg, names, total_steps, clip=35.0):
        """``names``: the leaves' state-dict names, in the order of
        ``step``'s lists (they decide which take weight decay)."""
        self.sched = one_cycle(cfg, total_steps)
        self.wd = float(cfg["optimizer"].get("VALUE", {}).get("wd", 0.0)) \
            if cfg["optimizer"].get("FIXED_WD", True) else 0.0
        self.decay = [not (n.endswith(".scale") or
                           (n.endswith(".bias") and ".norm" in n
                            or n.endswith("_bn.bias"))) for n in names]
        gc = cfg.get("optimizer_config", {}).get("grad_clip", {})
        self.clip = float(gc.get("max_norm", clip))
        self.count = 0
        self.mu = self.nu = None

    @torch.no_grad()
    def step(self, params, grads):
        gn = torch.sqrt(sum((g.double() * g.double()).sum() for g in grads))
        if float(gn) >= self.clip:
            grads = [(g / gn.float()) * self.clip for g in grads]
        lr, b1 = self.sched(self.count)
        b2, eps = 0.99, 1e-8
        if self.mu is None:
            self.mu = [torch.zeros_like(g) for g in grads]
            self.nu = [torch.zeros_like(g) for g in grads]
        self.count += 1
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        for p, g, m, v, dec in zip(params, grads, self.mu, self.nu,
                                   self.decay):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * g * g + b2 * v)
            d = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if dec and self.wd:
                d = d + self.wd * p
            p.add_(-lr * d)
        return float(gn), b1


# ---------------------------------------------------------------------------
# rotated IoU (float64) for the NMS check
# ---------------------------------------------------------------------------

def corners(b5):
    """(..., 5) [x, y, w, l, r] -> (..., 4, 2) counterclockwise corners,
    w along x and l along y before the rotation."""
    x, y, w, l, r = (b5[..., i] for i in range(5))
    c, s = torch.cos(r), torch.sin(r)
    sx = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=b5.dtype,
                      device=b5.device)
    sy = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=b5.dtype,
                      device=b5.device)
    lx = w[..., None] * sx
    ly = l[..., None] * sy
    # Det3D's rotation_2d: p @ [[c, -s], [s, c]]
    px = lx * c[..., None] + ly * s[..., None] + x[..., None]
    py = -lx * s[..., None] + ly * c[..., None] + y[..., None]
    pts = torch.stack([px, py], -1)
    area2 = ((pts[..., 1, 0] - pts[..., 0, 0]) * (pts[..., 2, 1]
                                                  - pts[..., 0, 1])
             - (pts[..., 1, 1] - pts[..., 0, 1]) * (pts[..., 2, 0]
                                                    - pts[..., 0, 0]))
    return torch.where((area2 >= 0)[..., None, None], pts, pts.flip(-2))


def convex_inter_area(p, q):
    """Intersection area of convex CCW quads p, q (M, 4, 2) float64 by
    Sutherland-Hodgman clipping of p against q's four edges."""
    m = p.shape[0]
    poly = torch.cat([p, p.new_zeros(m, 4, 2)], 1)       # up to 8 vertices
    n = torch.full((m,), 4, dtype=torch.long, device=p.device)
    ar = torch.arange(8, device=p.device)
    for e in range(4):
        a, b = q[:, e], q[:, (e + 1) % 4]
        ex, ey = (b - a)[:, 0:1], (b - a)[:, 1:2]
        side = ex * (poly[..., 1] - a[:, 1:2]) - ey * (poly[..., 0]
                                                      - a[:, 0:1])
        live = ar[None] < n[:, None]
        nxt_i = torch.where(ar[None] + 1 < n[:, None], ar[None] + 1, 0)
        nxt = torch.gather(poly, 1, nxt_i[..., None].expand(-1, -1, 2))
        snxt = torch.gather(side, 1, nxt_i)
        inside = side >= 0
        inside_n = snxt >= 0
        t = side / torch.where(side - snxt == 0, 1.0, side - snxt)
        cross = poly + t[..., None] * (nxt - poly)
        # each vertex emits: itself if inside, the crossing if the edge
        # to the next vertex crosses the line
        emit_v = live & inside
        emit_c = live & (inside != inside_n)
        cand = torch.stack([poly, cross], 2).reshape(m, 16, 2)
        keep = torch.stack([emit_v, emit_c], 2).reshape(m, 16)
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        cand = torch.gather(cand, 1, order[..., None].expand(-1, -1, 2))
        n = keep.sum(1)
        poly = cand[:, :8]
        n = torch.clamp(n, max=8)
    live = ar[None] < n[:, None]
    nxt_i = torch.where(ar[None] + 1 < n[:, None], ar[None] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_i[..., None].expand(-1, -1, 2))
    cr = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return 0.5 * torch.abs(torch.where(live, cr, 0.0).sum(1))


def rotated_iou(a5, b5):
    """IoU of rotated BEV boxes, pairwise over the rows of a5 (M, 5) and
    b5 (M, 5), float64."""
    a5, b5 = a5.double(), b5.double()
    inter = convex_inter_area(corners(a5), corners(b5))
    ua = a5[:, 2] * a5[:, 3] + b5[:, 2] * b5[:, 3] - inter
    return torch.where(ua > 0, inter / torch.where(ua > 0, ua, 1.0), 0.0)
