"""The dense tail's masked dense twin, for the tests of the rows tail
(models/backbones.py::_RowsTail) on the CPU and on the card: the
layers' dense forwards over the occupancy and its max-pooled cover, as
the JAX package computes the tail, from the transition rows the rows
tail starts from. Imports no JAX."""

import numpy as np
import torch
import torch.nn.functional as F

from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.ops import sparse as sp


def occupancy(coords, shape):
    """(B, V, 3) zyx -> (B, D, H, W) bool active-site mask."""
    b = coords.shape[0]
    n = int(np.prod(shape))
    lin = sp.linearize(coords, shape)
    keep = lin != sp._SENTINEL
    flat = (torch.arange(b, device=lin.device)[:, None] * n
            + torch.where(keep, lin, 0))
    occ = torch.zeros(b * n, dtype=torch.bool, device=lin.device)
    occ[flat[keep]] = True
    return occ.view(b, *shape)


def cover_mask(occ, kernel, stride, padding):
    """A strided conv's outputs: every site whose footprint covers an
    active input, a max-pool of the occupancy."""
    return F.max_pool3d(occ[:, None].float(), kernel, stride,
                        padding)[:, 0] > 0


def tail_layers(middle):
    """The middle's tail layers in call order."""
    if isinstance(middle, bb.SpMiddleResNetFHD):
        convs = iter(middle._names["DenseConvBN"])
        blocks = iter(middle._names["DenseBasicBlock"])
        names = [next(blocks), next(blocks)]
        for _ in range(3 - middle.start):
            names += [next(convs), next(blocks), next(blocks)]
        names.append(next(convs))
    else:
        names = middle._dense
    return [getattr(middle, n) for n in names]


def dense_twin(middle, x, co, shape, dt):
    """The masked dense tail from the transition rows (x, co at shape):
    scattered to the grid, each layer's dense forward over the occupancy,
    a strided layer's over its cover, the depth folded."""
    occ = occupancy(co, shape)
    xd = sp.to_dense(x, co, shape)
    for layer in tail_layers(middle):
        if isinstance(layer, bb.DenseConvBN) and layer.stride != (1, 1, 1):
            occ = cover_mask(occ, layer.kernel, layer.stride, layer.padding)
        xd = layer(xd, occ, dt)
    return bb._fold_depth(xd), occ


def run_rows(middle, feats, coords, input_shape, monkeypatch, plan=None):
    """(the middle's output, the transition rows (x, co, shape, dt) its
    tail started from)."""
    seen = []

    class Spy(bb._RowsTail):
        def __init__(self, x, co, shape, dt, training):
            seen.append((x, co, shape, dt))
            super().__init__(x, co, shape, dt, training)

    monkeypatch.setattr(bb, "_RowsTail", Spy)
    out = middle(feats, coords, input_shape, plan)
    (start,) = seen
    return out, start


def rows_tail(middle, x, co, shape, dt, training=True):
    """The rows tail (models/backbones.py::_RowsTail) of ``middle``'s
    layers in call order, from the transition rows: what the middle's
    forward runs, here on any device and in any dtype (fp64 on the CPU:
    the window conv's plain twins)."""
    tail = bb._RowsTail(x, co, shape, dt, training)
    layers = tail_layers(middle)
    for i, layer in enumerate(layers):
        if isinstance(layer, bb.DenseConvBN) and layer.stride != (1, 1, 1):
            tail.down(layer, last=i == len(layers) - 1)
        else:
            tail.blocks([layer])
    return tail.bev()
