"""The optimizer: the JAX package's optax chain as an explicit update.

Port of det3d_tpu/solver/optim.py::build_optimizer (and its BN mask,
``_non_bn_mask``). For ``TYPE="adam"`` the chain is, on the gradients of
one step:

1. ``clip_by_global_norm(grad_clip_norm)``: g is kept where its global
   L2 norm is below the limit, else ``(g / norm) * limit`` (no epsilon,
   unlike ``torch.nn.utils.clip_grad_norm_``);
2. Adam with b2 = 0.99 and eps = 1e-8 outside the square root,
   ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g² + b2 nu``, each
   divided by its bias correction ``1 - b ** count`` (count after the
   increment, with the current b1);
3. with ``FIXED_WD`` the decoupled decay ``wd * p`` added to the Adam
   direction, except on BatchNorm scales and biases;
4. the update ``-lr * direction``.

``lr`` and ``b1`` come from the schedules at the count before the
increment, as optax.inject_hyperparams evaluates them. The count, the
moments and the schedules' values live on the parameters' device, and
nothing is read back to the host, so the update can be captured in a
CUDA graph with the rest of the train step. ``sgd`` / ``momentum`` is
optax.sgd (a momentum trace, then ``-lr``), ``rms_prop`` optax.rmsprop
(``g * rsqrt(nu + eps)``, ``-lr``, then a momentum trace).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from det3d_tpu_torch.models.norm import MaskedBatchNorm


def non_bn_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: takes weight decay}: every parameter but the scale
    and bias of a BatchNorm (fastai's bn_wd=False). The JAX package
    matches BN parameters by their path names (``_non_bn_mask``); the port
    by their module's type."""
    bn = {f"{name}.{p}" if name else p
          for name, m in model.named_modules()
          if isinstance(m, MaskedBatchNorm)
          for p, _ in m.named_parameters(recurse=False)}
    return {name: name not in bn for name, _ in model.named_parameters()}


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all the tensors together, as a 0-d device tensor."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """The update of one optax chain over a model's parameters.

    ``params`` (name, parameter) pairs; ``decay`` the names that take
    weight decay. State: ``count`` (int32, on the parameters' device),
    ``mu`` and ``nu`` (Adam), ``trace`` (sgd, rms_prop with momentum),
    by parameter name, as optax's state holds them by path.
    ``update(grads)`` applies one step in place and returns the global
    norm of ``grads`` before clipping."""

    def __init__(self, params, kind: str, lr_fn: Callable,
                 mom_fn: Optional[Callable] = None, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-8, weight_decay=0.0,
                 decay=(), grad_clip_norm: Optional[float] = 35.0,
                 momentum: Optional[float] = None, rms_decay: float = 0.9):
        self.names: List[str] = [n for n, _ in params]
        self.params: List[torch.Tensor] = [p for _, p in params]
        self.kind = kind
        self.lr_fn, self.mom_fn = lr_fn, mom_fn
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = float(weight_decay)
        self.decay = [n in set(decay) for n in self.names]
        self.grad_clip_norm = grad_clip_norm
        self.momentum = momentum
        self.rms_decay = rms_decay
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

        def zeros():
            return [torch.zeros_like(p) for p in self.params]
        self.mu = zeros() if kind == "adam" else None
        self.nu = zeros() if kind in ("adam", "rms_prop") else None
        self.trace = zeros() if momentum is not None else None

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer's state."""
        out = [self.count]
        for s in (self.mu, self.nu, self.trace):
            out += s or []
        return out

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"mu" / "nu" / "trace": {parameter name: tensor}} and
        {"count": tensor}."""
        out = {"count": self.count}
        for key in ("mu", "nu", "trace"):
            if getattr(self, key) is not None:
                out[key] = dict(zip(self.names, getattr(self, key)))
        return out

    def hyperparams(self):
        """(lr, b1) at the current count, before its increment, as 0-d fp32
        tensors (b1 None without a momentum schedule)."""
        lr = self.lr_fn(self.count)
        b1 = self.mom_fn(self.count) if self.mom_fn is not None else None
        return lr, b1

    @torch.no_grad()
    def update(self, grads) -> torch.Tensor:
        grads = list(grads)
        g_norm = global_norm(grads)
        if self.grad_clip_norm is not None:
            keep = g_norm < self.grad_clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip_norm)
                     for g in grads]
        lr, b1 = self.hyperparams()
        count = self.count + 1
        if self.kind == "adam":
            dirs = self._adam(grads, self.b1 if b1 is None else b1, count)
            if self.weight_decay:
                dirs = [d + self.weight_decay * p if wd else d
                        for d, p, wd in zip(dirs, self.params, self.decay)]
            steps = [-lr * d for d in dirs]
        elif self.kind == "sgd":
            steps = [-lr * t for t in self._trace(grads)]
        else:
            steps = self._trace([-lr * d for d in self._rms(grads)])
        for p, s in zip(self.params, steps):
            p.add_(s)
        self.count.copy_(count)
        return g_norm

    def _adam(self, grads, b1, count):
        b2 = self.b2
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        out = []
        for g, mu, nu in zip(grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            out.append((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))
        return out

    def _trace(self, grads):
        if self.trace is None:
            return grads
        for g, t in zip(grads, self.trace):
            t.copy_(g + self.momentum * t)
        return list(self.trace)

    def _rms(self, grads):
        d = self.rms_decay
        out = []
        for g, nu in zip(grads, self.nu):
            nu.copy_((1 - d) * (g * g) + d * nu)
            out.append(torch.rsqrt(nu + self.eps) * g)
        return out


def build_optimizer(optimizer_cfg: dict, model: nn.Module, lr_fn: Callable,
                    mom_fn: Optional[Callable] = None,
                    grad_clip_norm: Optional[float] = 35.0) -> Optimizer:
    """The optimizer of a reference-schema config (e.g. ``dict(TYPE="adam",
    VALUE=dict(amsgrad=0.0, wd=0.01), FIXED_WD=True)``) over ``model``'s
    parameters, with the schedules ``lr_fn`` and ``mom_fn`` (b1; 0.9
    without one) and gradient clipping at ``grad_clip_norm`` (None: off)."""
    kind = str(optimizer_cfg.get("TYPE",
                                 optimizer_cfg.get("type", "adam"))).lower()
    value = optimizer_cfg.get("VALUE", optimizer_cfg.get("value", {}))
    params = list(model.named_parameters())
    common = dict(lr_fn=lr_fn, grad_clip_norm=grad_clip_norm)
    if kind == "adam":
        fixed_wd = bool(optimizer_cfg.get("FIXED_WD", True))
        mask = non_bn_mask(model)
        return Optimizer(params, "adam", mom_fn=mom_fn,
                         weight_decay=float(value.get("wd", 0.01))
                         if fixed_wd else 0.0,
                         decay=[n for n, d in mask.items() if d], **common)
    if kind in ("sgd", "momentum"):
        return Optimizer(params, "sgd", momentum=float(
            value.get("momentum_optimizer_value", 0.9)), **common)
    if kind == "rms_prop":
        return Optimizer(params, "rms_prop", rms_decay=float(
            value.get("decay", 0.9)), eps=float(value.get("epsilon", 1e-8)),
            momentum=float(value.get("momentum_optimizer_value", 0.0)),
            **common)
    raise ValueError(f"unknown optimizer type {kind}")
