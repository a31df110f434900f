"""The port's dense tail on its active rows (det3d_tpu_torch/models/
backbones.py::_RowsTail), on the CPU, where the window conv runs its plain
twins.

The tail builds its own rulebooks and runs every tail layer as a window
conv on the active sites; the masked dense twin (tests/dense_tail_twin.py:
the layers' dense forwards over the occupancy and its max-pooled cover, as
the JAX package computes the tail) gives the same map from the same
transition rows: SpMiddleFHD from stage 3 and SpMiddleResNetFHD from stage
2, in fp32 within TOL, in bf16 within BF16_REL, every tail parameter's
gradient in training too; with a stage cap below the tail's strided
outputs all of them are kept. The tail runs one window conv a layer: 4 in
SpMiddleFHD's (3 submanifold, the z conv), 10 in SpMiddleResNetFHD's.
"""

import copy

import numpy as np
import pytest
import torch

from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.models.norm import MaskedBatchNorm
from tests.dense_tail_twin import (cover_mask, dense_twin, occupancy,
                                   run_rows)

torch.set_num_threads(2)

TGRID = (48, 48, 40)            # (nx, ny, nz): res0 (41, 48, 48)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 1e-2                 # a sum in another order flips bf16 roundings

# name: (middle class, dense_from, stage_caps, window convs of the tail)
MIDDLES = {
    "fhd_from3": (bb.SpMiddleFHD, 3, (1.0,) * 4, 4),
    "resnet_from2": (bb.SpMiddleResNetFHD, 2, (1.0,) * 4, 10),
    # stage 3's strided conv, in the tail, has more outputs than its cap
    "resnet_from2_capped": (bb.SpMiddleResNetFHD, 2, (1.0, 1.0, 0.1, 0.1),
                            10),
}


def make_middle(name, precision="fp32"):
    cls, dense_from, caps, _ = MIDDLES[name]
    torch.manual_seed(0)
    middle = cls(num_input_features=4, dense_from=dense_from,
                 stage_caps=caps, norm_cfg={"type": "BN"},
                 precision=precision)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in middle.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.mean.shape[0]
                m.mean.copy_(0.1 * torch.randn(c, generator=g))
                m.var.copy_(0.5 + torch.rand(c, generator=g))
                m.scale.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
            elif isinstance(m, (bb.DenseConvBN, bb.SparseConvBN)):
                if m.bias is not None:
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                                   generator=g))
    return middle


def voxels(seed, b=2, v=384, n=320):
    """(features (B, V, 4), coords (B, V, 3)): n distinct random cells a
    sample, the rest padding."""
    r = np.random.RandomState(seed)
    nx, ny, nz = TGRID
    co = np.full((b, v, 3), -1, np.int32)
    for i in range(b):
        lin = r.choice((nz + 1) * ny * nx, n, replace=False)
        co[i, :n] = np.stack([lin // (ny * nx), (lin // nx) % ny,
                              lin % nx], -1)
    return (torch.from_numpy(r.randn(b, v, 4).astype(np.float32)),
            torch.from_numpy(co))


@pytest.mark.parametrize("name", list(MIDDLES))
def test_rows_tail_equals_dense_twin_fp32(name, monkeypatch):
    middle = make_middle(name).eval()
    feats, coords = voxels(3)
    with torch.no_grad():
        out, (x, co, shape, dt) = run_rows(middle, feats, coords, TGRID,
                                           monkeypatch)
        ref, occ = dense_twin(middle, x, co, shape, dt)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, **TOL)
    assert float(ref.abs().max()) > 0.1
    if name.endswith("capped"):
        # res3's outputs outnumber stage 3's cap, and every one is kept
        cap = max(64, int(coords.shape[1] * MIDDLES[name][2][2]))
        res3 = cover_mask(occupancy(co, shape), (3, 3, 3), (2, 2, 2),
                          (0, 1, 1)).flatten(1).sum(1)
        assert (res3 > cap).all(), (res3, cap)
        assert (ref != 0).any(-1).sum() > 0


@pytest.mark.parametrize("name", ["fhd_from3", "resnet_from2"])
def test_rows_tail_equals_dense_twin_bf16(name, monkeypatch):
    """bf16 serving: the tail's operands and its epilogue in bf16, as the
    dense twin's."""
    middle = make_middle(name, precision="bf16").eval()
    feats, coords = voxels(4)
    with torch.no_grad():
        out, (x, co, shape, dt) = run_rows(middle, feats, coords, TGRID,
                                           monkeypatch)
        ref, _ = dense_twin(middle, x, co, shape, dt)
    assert x.dtype == out.dtype == ref.dtype == torch.bfloat16
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel < BF16_REL, rel


@pytest.mark.parametrize("name", list(MIDDLES))
def test_rows_tail_gradients_equal_dense_twin(name, monkeypatch):
    """In training (BN on the batch statistics of the active sites, the
    strided convs' dX over their inverse rulebooks) every tail parameter's
    gradient equals the dense twin's."""
    middle = make_middle(name).train()
    twin = copy.deepcopy(middle)
    feats, coords = voxels(5)
    out, (x, co, shape, dt) = run_rows(middle, feats, coords, TGRID,
                                       monkeypatch)
    ref, _ = dense_twin(twin, x.detach(), co, shape, dt)
    torch.testing.assert_close(out, ref, **TOL)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
    names = [n for n, _ in middle.named_parameters()
             if n.startswith("Dense")]
    got = torch.autograd.grad((out * ct).sum(),
                              [middle.get_parameter(n) for n in names])
    want = torch.autograd.grad((ref * ct).sum(),
                               [twin.get_parameter(n) for n in names])
    assert len(names) >= 8
    # a conv bias before a BN on batch statistics has a zero gradient, up
    # to rounding: the absolute limit scales with the largest gradient
    scale = max(float(w.abs().max()) for w in want)
    for n, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale,
                                   msg=n)


@pytest.mark.parametrize("name", list(MIDDLES))
def test_rows_tail_runs_one_window_conv_a_layer(name, monkeypatch):
    """The tail runs each of its layers as one window conv, and nothing
    else of the forward's window convs: every conv from the transition's
    rows on is a tail layer's."""
    middle = make_middle(name).eval()
    feats, coords = voxels(3)
    calls = []

    def counted(*args, **kw):
        calls.append(args[2].shape)
        return real(*args, **kw)
    real = bb.window_conv
    monkeypatch.setattr(bb, "window_conv", counted)
    seen = []

    class Spy(bb._RowsTail):
        def __init__(self, *args):
            seen.append(len(calls))
            super().__init__(*args)
    monkeypatch.setattr(bb, "_RowsTail", Spy)
    with torch.no_grad():
        middle(feats, coords, TGRID)
    tail = calls[seen[0]:]
    n_dense = sum(isinstance(m, bb.DenseConvBN) for m in middle.modules())
    assert len(tail) == n_dense == MIDDLES[name][3], (len(tail), n_dense)
    # the z conv last: (3, 1, 1) taps
    assert tail[-1][0] == 3
