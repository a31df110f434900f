"""Operation and byte counts of the port's steps, and their share of the
card's peaks.

The counterpart of the JAX package's ``tools/get_flops.py`` and
``tools/mfu.py``, which read XLA's cost analysis and divide by TPU peaks.
Here the count follows each operation's own rule, so a step counts the
same work whatever runs it, on the CPU or on the card:

- dense convolutions, transposed convolutions and matrix products are
  seen through a ``TorchDispatchMode`` over the aten ops, at 2 x the
  multiply-adds that read an in-bounds input (XLA's convention: a padded
  tap is no work);
- the port's own CUDA kernels report their work through the rule their
  wrapper registers (``register``, ``kernel``): the window conv counts
  2 Cin Cout for each present tap that reads a row (``conv_work``), the
  rotated NMS a distance test for each valid pair and an IoU for each
  pair near enough to need one (``nms_bound``). The aten ops of their
  plain twins, which run instead of them on the CPU, are not counted;
- bytes are each counted op's operands and output, unfused: an upper
  bound of what the step moves, as XLA's "bytes accessed" is.

The peaks are the published ones of the card the port targets (``CARD``),
and ``bound`` turns bytes and operations into the least time the card
could take. ``python -m det3d_tpu_torch.cli flops CONFIG`` prints a
step's count by stage and, with ``--time``, its share of those peaks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from det3d_tpu_torch.utils.trace import STAGES

# NVIDIA H100 SXM 80GB (HBM3), published dense peaks at its 700 W limit:
# HBM bytes/s, fp32 FLOP/s on the CUDA cores (TF32 off), bf16 FLOP/s on
# the tensor cores
CARD = "NVIDIA H100 80GB HBM3"
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
NMS_FLOPS_PER_PAIR = 250        # ~ fp32 operations of one pair IoU
NMS_FLOPS_PER_TEST = 10         # ~ fp32 operations of one circumcircle test


def peak_of(dtype) -> float:
    """The card's peak FLOP/s for operands of ``dtype``."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else FP32_FLOPS


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nms_bound(corners, area, valid):
    """Rotated NMS keep, the work these inputs need: a distance test
    (NMS_FLOPS_PER_TEST) for every pair of valid boxes and a full IoU
    (NMS_FLOPS_PER_PAIR) for the pairs near_pairs keeps; inputs read once,
    the keep mask written once. Returns (bound_ms, bound_by,
    all_pairs_ms): the last the bound of a full IoU for every valid
    pair."""
    nbytes, flops = nms_work(corners, area, valid)
    v = valid.sum(dim=1).double()
    pairs = float((v * (v - 1) / 2).sum())
    b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
    return b_ms, b_by, bound(nbytes, pairs * NMS_FLOPS_PER_PAIR,
                             FP32_FLOPS)[0]


def nms_work(corners, area, valid):
    """(bytes, flops) of one rotated NMS keep on these inputs (nms_bound's
    rule)."""
    from det3d_tpu_torch.ops.nms_cuda import near_pairs
    v = valid.sum(dim=1).double()
    pairs = float((v * (v - 1) / 2).sum())
    near = float(near_pairs(corners, area, valid).sum())
    nbytes = corners.numel() * 4 + area.numel() * 4 + 2 * valid.numel()
    return nbytes, pairs * NMS_FLOPS_PER_TEST + near * NMS_FLOPS_PER_PAIR


def tap_rows(packed, v, center_shift, kz=3):
    """(rows, sel), each (B, O, K, kz): the input row tap j of column k
    reads for output o, and whether it reads one (the tap is present and
    the row lies in [0, V)). The rules are window_conv_ref's."""
    from det3d_tpu_torch.ops.sparse import unpack_windows
    r0, pres = unpack_windows(packed, kz)
    o, kbev = pres.shape[1:3]
    off = pres.long().cumsum(-1) - pres.long()       # popcount(pres[:j])
    rows = r0.clamp(max=max(v - 1, 0))[..., None] + off
    if center_shift:
        rows[:, :, kbev // 2] = (torch.arange(o, device=rows.device)[:, None]
                                 - 1 + torch.arange(kz, device=rows.device))
    return rows, pres & (rows >= 0) & (rows < v)


def conv_taps(packed, v, center_shift, kz=3):
    """(taps, rows) of one window conv on this plan: the present taps that
    read an input row (rows past V or before 0 read zero), and the distinct
    input rows they read, over the batch."""
    rows, sel = tap_rows(packed, v, center_shift, kz)
    b = rows.shape[0]
    batch = torch.arange(b, device=rows.device).view(b, 1, 1, 1)
    hit = torch.zeros(b, max(v, 1), dtype=torch.bool, device=rows.device)
    hit[batch.expand_as(rows)[sel], rows[sel]] = True
    return int(sel.sum()), int(hit.sum())


def conv_work(features, packed, weights, center_shift):
    """(bytes, flops, peak) of one window conv: the input rows that present
    taps read, each once, the packed plan and the weights read once, the
    fp32 output written once; 2 Cin Cout flops per tap that reads a row.
    fp32 operands at the CUDA-core rate, bf16 at the tensor-core rate."""
    b, o, k = packed.shape
    kvol, cin, cout = weights.shape
    taps, rows = conv_taps(packed, features.shape[1], center_shift,
                           kvol // k)
    elt = features.element_size()
    nbytes = (rows * cin * elt + packed.numel() * 4
              + weights.numel() * elt + b * o * cout * 4)
    return nbytes, 2.0 * cin * cout * taps, peak_of(features.dtype)


def inverse_work(dy, inverse, weights, kernel, stride, v):
    """(bytes, flops, peak) of a strided window conv's dX over its packed
    inverse rulebook: 2 Cin Cout for each (input row, tap) pair whose
    candidate output is present and whose parity matches (the forward's
    pairs); dy, the words and the weights read once, dX written once."""
    from det3d_tpu_torch.ops.sparse import ncand_of, unpack_inverse
    k3, s3 = tuple(kernel), tuple(stride)
    nc = ncand_of(k3, s3)
    _, presi, par = unpack_inverse(inverse, nc[0])
    kvol, cin, cout = weights.shape
    pairs = 0
    for kk in range(kvol):
        j = (kk // (k3[1] * k3[2]), (kk // k3[2]) % k3[1], kk % k3[2])
        c = tuple(j[d] // s3[d] for d in range(3))
        if any(c[d] >= nc[d] for d in range(3)):
            continue
        pm = ((par[..., 0] == j[0] % s3[0]) & (par[..., 1] == j[1] % s3[1])
              & (par[..., 2] == j[2] % s3[2]))
        pairs += int((presi[:, :, c[1] * nc[2] + c[2], nc[0] - 1 - c[0]]
                      & pm).sum())
    b = dy.shape[0]
    nbytes = (dy.numel() * dy.element_size() + inverse.numel() * 4
              + weights.numel() * 4 + b * v * cin * 4)
    return nbytes, 2.0 * cin * cout * pairs, FP32_FLOPS


# ---------------------------------------------------------------------------
# The count of a step
# ---------------------------------------------------------------------------

# name -> rule(*args) -> (bytes, flops, peak), registered by the wrappers
_RULES: Dict[str, Callable] = {}
_COUNTERS = []                  # the active FlopCounters, innermost last


def register(name: str, rule: Callable):
    """A kernel wrapper's rule: ``rule(*args)`` -> (bytes, flops, peak) of
    one launch on those arguments."""
    _RULES[name] = rule


@contextlib.contextmanager
def kernel(name: str, *args):
    """Wrap one call of the port's kernel ``name`` (launch or plain twin):
    while a FlopCounter is active, count its registered rule on ``args``
    and hide the aten ops inside from it. Free when none is."""
    if not _COUNTERS:
        yield
        return
    counter = _COUNTERS[-1]
    counter._hidden += 1
    try:
        nbytes, flops, peak = _RULES[name](*args)
        counter.add(name, flops, nbytes, peak, kernel=True)
        yield
    finally:
        counter._hidden -= 1


def _in_bounds_pairs(length_in, length_out, k, s, p, d, transposed):
    """Per spatial dim, the (output, tap) pairs of a conv that read an
    in-bounds input (transposed: the (input, tap) pairs that write an
    in-bounds output)."""
    o = torch.arange(length_in if transposed else length_out)
    t = torch.arange(k)
    pos = o[:, None] * s - p + t[None, :] * d
    lim = length_out if transposed else length_in
    return int(((pos >= 0) & (pos < lim)).sum())


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation,
               transposed, groups):
    """2 x the multiply-adds of an aten convolution that touch an
    in-bounds input."""
    n, spatial = x_shape[0], len(x_shape) - 2
    if transposed:
        cin, cout_g = w_shape[0], w_shape[1]
        cout = cout_g * groups
    else:
        cout, cin_g = w_shape[0], w_shape[1]
        cin = cin_g * groups
    pairs = 1
    for i in range(spatial):
        pairs *= _in_bounds_pairs(x_shape[2 + i], out_shape[2 + i],
                                  w_shape[2 + i], stride[i], padding[i],
                                  dilation[i], transposed)
    return 2.0 * n * (cin // groups) * cout * pairs


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


class FlopCounter(TorchDispatchMode):
    """Counts the operations and bytes of the code run under it, by stage.

    ``stage``: the name new counts go to (``stages`` keeps them in first
    use order). Each entry holds flops, bytes, the flops inside the
    port's own kernels (``kernel_flops``), the time of the operations at
    their operands' peak (``ops_ms``) and the least time the card could
    take, op by op the larger of that and its bytes' (``bound_ms``)."""

    _ATEN = None

    def __init__(self):
        super().__init__()
        self.stage = "total"
        self.stages: Dict[str, Dict[str, float]] = {}
        self.by_kernel: Dict[str, int] = {}
        self._hidden = 0

    def add(self, name, flops, nbytes, peak, kernel=False):
        st = self.stages.setdefault(self.stage, dict(
            flops=0.0, bytes=0.0, kernel_flops=0.0, ops_ms=0.0,
            bound_ms=0.0))
        st["flops"] += flops
        st["bytes"] += nbytes
        st["ops_ms"] += flops / peak * 1e3
        st["bound_ms"] += bound(nbytes, flops, peak)[0]
        if kernel:
            st["kernel_flops"] += flops
            self.by_kernel[name] = self.by_kernel.get(name, 0) + 1

    def totals(self):
        out = dict(flops=0.0, bytes=0.0, kernel_flops=0.0, ops_ms=0.0,
                   bound_ms=0.0)
        for st in self.stages.values():
            for k in out:
                out[k] += st[k]
        return out

    def __enter__(self):
        _COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return super().__exit__(*exc)

    @classmethod
    def _ops(cls):
        if cls._ATEN is None:
            a = torch.ops.aten
            cls._ATEN = {"mm": a.mm.default, "addmm": a.addmm.default,
                         "bmm": a.bmm.default, "baddbmm": a.baddbmm.default,
                         "conv": a.convolution.default,
                         "conv_bwd": a.convolution_backward.default}
        return cls._ATEN

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        ops = self._ops()
        if func in (ops["mm"], ops["bmm"]):
            a, b = args[0], args[1]
            flops = 2.0 * a.numel() * b.shape[-1]
            self.add(func.__name__, flops, _nbytes(a, b, out),
                     peak_of(a.dtype))
        elif func in (ops["addmm"], ops["baddbmm"]):
            a, b = args[1], args[2]
            flops = 2.0 * a.numel() * b.shape[-1]
            self.add(func.__name__, flops, _nbytes(args[0], a, b, out),
                     peak_of(a.dtype))
        elif func is ops["conv"]:
            x, w = args[0], args[1]
            stride, padding, dilation, transposed = args[3:7]
            flops = conv_flops(x.shape, w.shape, out.shape, stride, padding,
                               dilation, transposed, args[8])
            self.add("convolution", flops, _nbytes(x, w, args[2], out),
                     peak_of(x.dtype))
        elif func is ops["conv_bwd"]:
            dy, x, w = args[0], args[1], args[2]
            stride, padding, dilation, transposed = args[4:8]
            mask = args[10]
            fwd = conv_flops(x.shape, w.shape, dy.shape, stride, padding,
                             dilation, transposed, args[9])
            flops = fwd * (int(mask[0]) + int(mask[1]))
            self.add("convolution_backward", flops,
                     _nbytes(dy, x, w, *[t for t in out if t is not None]),
                     peak_of(x.dtype))
        return out


def stage_hooks(model, counter: FlopCounter):
    """Point ``counter.stage`` at the detector's stage that runs: voxelize
    before the reader, then reader, backbone, neck and bbox_head, and
    decode+nms after the head. Returns the hooks' handles."""
    for name in STAGES:
        counter.stage = name
        counter.add(name, 0.0, 0.0, FP32_FLOPS)
    counter.by_kernel.clear()
    counter.stage = "voxelize"
    handles = []
    for name in ("reader", "backbone", "neck", "bbox_head"):
        mod = getattr(model, name, None)
        if mod is None:
            continue

        def pre(_m, _a, name=name):
            counter.stage = name

        handles.append(mod.register_forward_pre_hook(pre))
    handles.append(model.bbox_head.register_forward_hook(
        lambda *_: setattr(counter, "stage", "decode+nms")))
    return handles


def count_step(run: Callable, model=None) -> FlopCounter:
    """Run ``run()`` once under a FlopCounter (by stage when ``model`` is a
    detector) and return the counter."""
    counter = FlopCounter()
    handles = stage_hooks(model, counter) if model is not None else []
    try:
        with counter:
            run()
    finally:
        for h in handles:
            h.remove()
    return counter


def stage_params(model) -> Dict[str, int]:
    """Parameters of each stage of a detector."""
    return {name: sum(p.numel() for p in getattr(model, name).parameters())
            for name in ("reader", "backbone", "neck", "bbox_head")
            if getattr(model, name, None) is not None}


def share(counter: FlopCounter, ms: float):
    """(share of peak, share of HBM) of a step that took ``ms`` on the
    card: its operations' time at their operands' peak over ``ms``, and
    its bytes' time at the HBM rate over ``ms``."""
    tot = counter.totals()
    return tot["ops_ms"] / ms, tot["bytes"] / HBM_BPS * 1e3 / ms
