"""The layer markers of utils/trace.py on the card.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and
skip elsewhere (the check runs inside a fixture, so every worker collects
the same tests). Run them on the card with

    python -m pytest tests/test_torch_trace_cuda.py -m cuda -q

- A toy step of three segments, captured while tracing is on: in each of
  two profiled replays the six marker records appear in order around the
  segments' kernels, and a ``record_function`` entered at capture labels
  none of the replay's records (it is not in the replay's trace at all).
- csrc/trace_marks.cu exports both markers of every SEGMENTS name, and
  the wrapper finds them as distinct kernels.
- A capture with tracing off launches no marker; with tracing on, two a
  segment entered at the warm-up and at the capture.
- SECOND's predict step (fed points alone: device voxels and plans, the
  dense tail) captured with tracing on returns the outputs of one
  captured with tracing off, to the bit; its train step, on cuDNN's
  deterministic algorithms, the same losses and updated leaves, to the
  bit.
"""

import numpy as np
import pytest
import torch

from det3d_tpu_torch import csrc
from det3d_tpu_torch.parallel.graph import CapturedStep
from det3d_tpu_torch.utils import trace
from tests.test_torch_predict_graph import path_step, train_steps

pytestmark = pytest.mark.cuda

TOY = ("voxelize", "reader", "neck")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def tracing():
    """Tracing on for the test, and off after it."""
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)


def toy_run(batch):
    x = batch["x"]
    with trace.segment("voxelize"):
        x = x * 2.0
    with trace.segment("reader"):
        with torch.profiler.record_function("toy.at_capture"):
            x = x + 1.0
    with trace.segment("neck"):
        x = x * 3.0
    return {"y": x}


def device_records(prof):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False))


def test_markers_of_a_toy_step_in_each_replay(dev, tracing):
    step = CapturedStep(toy_run, dev)
    batch = {"x": np.arange(1024, dtype=np.float32)}
    step(batch)                                   # warm-up, capture
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            out = step(batch)
        torch.cuda.synchronize()
    assert torch.equal(out["y"].cpu(),
                       torch.from_numpy((batch["x"] * 2 + 1) * 3))
    recs = device_records(prof)
    marks = [n for _, _, n in recs if n.startswith("mark_")]
    one = [f"mark_{w}_{s}" for s in TOY for w in ("begin", "end")]
    assert marks == one * 2, marks
    # each segment's one kernel lies between its markers, in every replay
    names = [n for _, _, n in recs]
    begins = [i for i, n in enumerate(names) if n == "mark_begin_voxelize"]
    ends = [i for i, n in enumerate(names) if n == "mark_end_neck"]
    for b, e in zip(begins, ends):
        part = names[b:e + 1]
        assert len(part) == 9, part
        assert part[0::3] == [f"mark_begin_{s}" for s in TOY], part
        assert part[2::3] == [f"mark_end_{s}" for s in TOY], part
        assert not any(p.startswith("mark_") for p in part[1::3]), part
    # the range entered at capture closed before any replay: no record of
    # the replays, on the host or the device, carries it
    assert "toy.at_capture" not in {e.name for e in prof.events()}
    host = {e.name for e in prof.events()
            if not str(e.device_type).endswith("CUDA")}
    assert {"step.stage_wait", "step.stage_copy", "step.launch",
            "step.outputs"} <= host


def test_trace_marks_exports_both_markers_of_every_segment(dev):
    lib = csrc.load("trace_marks")
    for name in trace.SEGMENTS:
        for w in ("begin", "end"):
            assert hasattr(lib, f"mark_{w}_{trace.marker_name(name)}"), name
    _, kernels = trace._markers()
    assert len(kernels) == len(trace.SEGMENTS)
    flat = [k for pair in kernels for k in pair]
    assert all(flat) and len(set(flat)) == len(flat)


def test_capture_with_tracing_off_launches_no_marker(dev):
    batch = {"x": np.ones(64, np.float32)}
    trace.segment.launches = 0
    step = CapturedStep(toy_run, dev)
    step(batch)
    step(batch)
    assert trace.segment.launches == 0
    trace.enable()
    try:
        traced = CapturedStep(toy_run, dev)
        traced(batch)
        # warm-up and capture, two markers a segment each; none at replay
        assert trace.segment.launches == 2 * 2 * len(TOY)
        traced(batch)
        assert trace.segment.launches == 2 * 2 * len(TOY)
    finally:
        trace.enable(False)


def test_predict_step_with_markers_equals_without(dev):
    plain, batch = path_step("second", dev, feed="points")
    out = plain(batch)
    trace.enable()
    try:
        marked, _ = path_step("second", dev, feed="points")
        trace.segment.launches = 0
        got = marked(batch)
        assert trace.segment.launches > 0
    finally:
        trace.enable(False)
    assert int(out["valid"].sum()) > 0
    for k in out:
        assert torch.equal(out[k], got[k]), k


def test_train_step_with_markers_equals_without(dev):
    """cuDNN's default backward algorithms sum in an order that differs
    from one run to the next (two captures with tracing off differ in the
    second loss by an ulp or two), so both captures take its deterministic
    ones: then two steps of each give the same losses and leaves, to the
    bit."""
    steps = []
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for on in (False, True):
            trace.enable(on)
            step, _, scans, state = train_steps("second", dev)
            steps.append(([step(scans)["loss"] for _ in range(2)], state))
    finally:
        trace.enable(False)
        torch.backends.cudnn.deterministic = was
    (l0, s0), (l1, s1) = steps
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for a, b in zip(s0.tensors(), s1.tensors()):
        assert torch.equal(a, b)
