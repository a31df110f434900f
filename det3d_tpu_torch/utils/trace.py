"""The port's tracing: one switch, host spans, device segments and their
counters, on torch.profiler's clock.

Off (the default), ``span`` and ``segment`` return one shared no-op
context: nothing is recorded and no marker is launched. ``enable()``
turns tracing on for the process; there is no other knob.

- ``span(name)``: a host span. It enters
  ``torch.profiler.record_function(name)``, so that a running profiler
  records it beside the CUDA records, and adds to an in-memory total per
  name: calls, and host seconds by ``time.perf_counter`` (``totals()``,
  cleared by ``reset()``). The totals count also where no profiler runs,
  as in a step's warm-up and capture. Spans nest: in the profiler a
  span's parent is the span open around it.
- ``segment(name)``: a span over one of ``SEGMENTS`` that also marks the
  device. On the current CUDA stream it launches the kernel
  ``mark_begin_<name>`` at entry and ``mark_end_<name>`` at exit
  (csrc/trace_marks.cu: one thread and no work; ``+`` spelled ``_``),
  counted in ``segment.launches``. Inside ``torch.cuda.graph`` capture the
  markers become nodes of the graph, so every replay of a graph captured
  while tracing was on puts them into the device trace, in order, around
  the segment's kernels. The host range of a segment closes at capture,
  before any replay, and a replay's kernels are the ``cudaGraphLaunch``'s
  in the profiler, never that range's: the markers are what carries the
  layers into a replay's trace. A graph captured with tracing off holds
  no marker.

Where they are entered: the detector's stages by ``stage_hooks``
(installed by parallel/predict.py::make_predict_step and
parallel/train.py::make_train_step), ``voxelize`` and ``targets`` in
parallel/train.py::build_example, ``plan`` and ``dense_tail`` in the
sparse middles (models/backbones.py), ``decode+nms`` in the predict step,
``loss``, ``backward`` and ``optimizer`` in the train step; the host spans
``step.*`` in parallel/graph.py::CapturedStep.

runtime/hooks.py::ProfilerHook turns tracing on for its whole run, not
only for the iterations it profiles: the trainer captures its step's
graph at the first iteration, so only a graph captured then carries the
markers. Every step of such a run replays them (13.5-19.0 us of device
time a call on an H100 80GB HBM3) and enters the step's host spans. The
hook writes ``totals()`` and the run's marker launches beside its Chrome
trace.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from typing import Dict, List, Tuple

import torch

# The detector's stages, which utils/flops.py counts by, then the parts of
# a step inside and around them.
STAGES = ("voxelize", "reader", "backbone", "neck", "bbox_head",
          "decode+nms")
SEGMENTS = STAGES + ("plan", "dense_tail", "targets", "loss", "backward",
                     "optimizer")

_on = False
_OFF = contextlib.nullcontext()
_totals: Dict[str, List] = {}


def enable(on: bool = True):
    """Turn tracing on (or off) for the whole process. Graphs captured
    while it is on carry the markers; those captured before do not."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def totals() -> Dict[str, Tuple[int, float]]:
    """{span or segment name: (calls, host seconds)} since the last
    ``reset()``, while tracing was on."""
    return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset():
    _totals.clear()


def marker_name(segment_name: str) -> str:
    """A segment's name as its markers spell it."""
    return segment_name.replace("+", "_")


@functools.lru_cache(maxsize=None)
def _markers():
    """The library's launcher, and the (begin, end) marker kernels of each
    of SEGMENTS in its order, looked up by symbol: a segment that
    csrc/trace_marks.cu does not mark fails here."""
    from det3d_tpu_torch import csrc
    lib = csrc.load("trace_marks")
    launch = lib.trace_mark_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    kernels = tuple(
        tuple(ctypes.cast(getattr(lib, f"mark_{w}_{marker_name(s)}"),
                          ctypes.c_void_p).value for w in ("begin", "end"))
        for s in SEGMENTS)
    return launch, kernels


def _mark(index: int, end: int):
    if not torch.cuda.is_initialized():
        return
    launch, kernels = _markers()
    stream = torch.cuda.current_stream().cuda_stream
    err = launch(kernels[index][end], stream)
    if err != 0:
        raise RuntimeError(f"trace marker {SEGMENTS[index]!r}: CUDA launch "
                           f"failed (cudaError {err})")
    segment.launches += 1


class _Span:
    """One span while tracing is on; ``mark`` is the segment's index in
    SEGMENTS, or None for a host span."""

    __slots__ = ("name", "mark", "_range", "_t0")

    def __init__(self, name, mark=None):
        self.name, self.mark = name, mark

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self.mark is not None:
            _mark(self.mark, 0)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self.mark is not None:
            _mark(self.mark, 1)
        self._range.__exit__(*exc)
        total = _totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += seconds
        return False


def span(name: str):
    """A host span named ``name`` (the shared no-op while tracing is
    off)."""
    return _Span(name) if _on else _OFF


def segment(name: str):
    """A span over the segment ``name`` of SEGMENTS, marked on the device
    (the shared no-op while tracing is off)."""
    if not _on:
        return _OFF
    return _Span(name, SEGMENTS.index(name))


segment.launches = 0


def stage_hooks(model):
    """Hooks on the detector's reader, backbone, neck and bbox_head that
    enter the stage's segment before its forward and leave it after; the
    same modules as utils/flops.py::stage_hooks. They read the switch at
    each forward, that is at a step's warm-up and capture, so a step made
    before tracing was turned on is traced all the same. Installed once a
    model; returns the hooks' handles."""
    handles = getattr(model, "_trace_stage_hooks", None)
    if handles is not None:
        return handles
    handles = []
    for name in ("reader", "backbone", "neck", "bbox_head"):
        mod = getattr(model, name, None)
        if mod is None:
            continue
        opened = []

        def pre(_m, _a, name=name, opened=opened):
            seg = segment(name)
            seg.__enter__()
            opened.append(seg)

        def post(_m, _a, _o, opened=opened):
            if opened:
                opened.pop().__exit__(None, None, None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post, always_call=True))
    model._trace_stage_hooks = handles
    return handles
