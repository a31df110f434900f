"""The model's weights and BatchNorm statistics, made from the seed.

Both sides get the same tensors: the program loads them as its state
dict, the reference reads them by name. Conv and linear weights come from
one uniform draw on the device (``torch.Generator`` seeded from the run's
seed), scaled per tensor to LeCun's variance 1/fan_in; biases and BN
shifts are zero, BN scales one. The BN statistics are then calibrated by
the reference on one scan (each layer's running mean and variance set to
those of its input there, layer after layer), so random weights do not
shrink the head's outputs to rounding noise, and the box-regression convs
are scaled by ``BOX_GAIN``: at unit scale the size deltas go through
exp() to boxes of 1e8 m whose IoUs are rounding noise; scaled, the boxes
stay near their anchors, as a trained head's do (chip_smoke.py's
``calibrated_state``, frozen here).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

BOX_GAIN = 0.1


def make_params(arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random weights of ``arch.param_spec()`` from ``seed``, in two large
    draws on ``device``: fp32, as the configs serve them."""
    spec = arch.param_spec()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    n_w = sum(math.prod(s) for _, s, kind, _ in spec if kind == "w")
    flat = torch.rand(n_w, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        if kind == "w":
            n = math.prod(shape)
            bound = math.sqrt(3.0 / fan_in)       # uniform of var 1/fan_in
            out[name] = ((flat[at:at + n] * 2 - 1) * bound).view(shape)
            at += n
        elif kind in ("scale", "var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


@torch.no_grad()
def calibrate(ref, arch, params, points, num_points):
    """Set every BN's statistics in ``params`` to those of its input on
    one scan (the reference's forward in "calib" mode), then scale the
    box convs. In place; returns ``params``."""
    ref.forward(arch, params, points, num_points, mode="calib")
    for name, w in params.items():
        if name.endswith("conv_box.weight"):
            w.mul_(BOX_GAIN)
    return params
