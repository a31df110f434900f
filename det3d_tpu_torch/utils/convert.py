"""Carry flax weights of the JAX package over to the port's modules.

``from_jax(params, batch_stats)`` takes the nested dicts of numpy arrays
that flax's variables become under ``np.asarray`` and returns the port's
``state_dict``. It needs no flax. Layouts:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel HWIO -> Conv2d weight OIHW;
- ConvTranspose kernel (kh, kw, in, out) -> flipped in both spatial axes,
  then ConvTranspose2d weight (in, out, kh, kw): flax's transposed conv
  (``transpose_kernel=False``) is the spatial flip of torch's;
- SparseConvBN_<n> kernel (kvol, Cin, Cout) keeps its z-major layout;
- DenseConvBN_<n> kernel (kz*ky*kx, Cin, Cout) -> (kz, ky, kx, Cin, Cout),
  as the JAX package reshapes it, then conv3d weight OIDHW;
- BatchNorm scale, bias, mean and var carry over as they are.

flax names a module's BatchNorms by call order (``MaskedBatchNorm_<n>``);
a layer's own one is the port's ``norm``, except in a module whose Dense
or Conv layers flax names by call order too (``Dense_<n>``, ``Conv_<n>``:
PointModule, RegHead, the PointNet++ SharedMLP, the image backbones'
blocks and stems), which the port names as flax does. L2Norm's ``gamma``
carries over as it is; a grouped conv's HWIO kernel (kh, kw, Cin/g, Cout)
becomes OIHW (Cout, Cin/g, kh, kw) as any other. The RPN's call order is block i's down
conv, its convs, then its upsample branch, which the port names
``block{i}_down_bn``, ``block{i}_conv{j}_bn`` and ``deblock{k}_bn``.
SpMiddleFHDNobn nests an SpMiddleFHD (``SpMiddleFHD_0``), whose layers
the port holds directly.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _rpn_bn_names(neck_params) -> list:
    """The port's BN names of the RPN in flax's call order."""
    n_blocks = len([k for k in neck_params
                    if re.fullmatch(r"block\d+_down_conv", k)])
    n_up = len([k for k in neck_params
                if re.fullmatch(r"deblock\d+_(deconv|conv)", k)])
    us_start = n_blocks - n_up
    names = []
    for i in range(n_blocks):
        names.append(f"block{i}_down_bn")
        n_conv = len([k for k in neck_params
                      if re.fullmatch(rf"block{i}_conv\d+_conv", k)])
        names += [f"block{i}_conv{j}_bn" for j in range(n_conv)]
        if i >= us_start:
            names.append(f"deblock{i - us_start}_bn")
    return names


# the dense tail's kernels, by tap count: its 3x3x3 convs and the final
# (3, 1, 1) z conv of SpMiddleFHD
_DENSE_KERNELS = {27: (3, 3, 3), 3: (3, 1, 1)}


def _kernel(path, w):
    """flax kernel -> torch weight, by the layer kind in its path."""
    if w.ndim == 2:                                   # Dense
        return w.T
    if path[-2].startswith("SparseConvBN_"):          # (kvol, in, out)
        return w
    if path[-2].startswith("DenseConvBN_"):
        kz, ky, kx = _DENSE_KERNELS[w.shape[0]]
        return w.reshape(kz, ky, kx, *w.shape[1:]).transpose(4, 3, 0, 1, 2)
    if path[-2].endswith("_deconv"):                  # ConvTranspose
        return w[::-1, ::-1].transpose(2, 3, 0, 1)
    return w.transpose(3, 2, 0, 1)                    # Conv HWIO -> OIHW


def from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """Map flax ``params`` / ``batch_stats`` of a PointPillars or VoxelNet
    detector, or of one of its modules (the PointNet++, temporal and image
    modules too), to the port's state_dict (float32 CPU tensors)."""
    flat_p = _flatten(params)
    flat_s = _flatten(batch_stats)
    bn_rename = {}
    if "neck" in params:
        for n, name in enumerate(_rpn_bn_names(params["neck"])):
            bn_rename[("neck", f"MaskedBatchNorm_{n}")] = ("neck", name)

    # modules whose layers keep flax's call-order names
    flax_named = {path[:-2] for path in flat_p
                  if path[-2] in ("Dense_0", "Conv_0")}

    def rename(path):
        # path without the leaf name
        if path[:2] == ("backbone", "SpMiddleFHD_0"):   # the Nobn middle
            path = path[:1] + path[2:]
        if path[:2] in bn_rename:
            return bn_rename[path[:2]] + path[2:]
        if path[-1] == "MaskedBatchNorm_0" and path[:-1] not in flax_named:
            return path[:-1] + ("norm",)              # a layer's own norm
        return path

    sd = {}
    for path, w in flat_p.items():
        mod, leaf = rename(path[:-1]), path[-1]
        if leaf == "kernel":
            w, leaf = _kernel(mod + (leaf,), w), "weight"
        sd[".".join(mod + (leaf,))] = w
    for path, w in flat_s.items():
        sd[".".join(rename(path[:-1]) + (path[-1],))] = w
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}
