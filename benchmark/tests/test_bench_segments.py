"""The program's segments and spans as the ``--trace 1`` stretch reads
them (core/trace.py), on synthetic profiler events: nesting and self
time, a lost marker, a record across a marker, idle time inside a
segment, gap labels and host spans' annotations on the device's rows;
and the program's tracing switched on only under ``--trace 1``."""

import json

import pytest

from benchmark.core import harness
from benchmark.core import trace as tr
from benchmark.tests import tiny


class Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class Event:
    """The fields of a torch.profiler event that core/trace.py reads."""

    def __init__(self, name, start, end, device=True, annotation=False):
        self.name = name
        self.time_range = Range(start, end)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.is_user_annotation = annotation


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def marked(name, a, b):
    """A segment's two one-microsecond markers, its begin ending at ``a``
    and its end starting at ``b``."""
    return [Event(f"mark_begin_{name}", a - 1, a),
            Event(f"mark_end_{name}", b, b + 1)]


def host(*spans):
    return [Event(n, a, b, device=False, annotation=True)
            for n, a, b in spans]


def test_nested_segments_give_self_and_total_times():
    ev = host(("step_call", 0, 1000), ("readback", 1000, 1100))
    ev += [Event("memcpyHtoD", 50, 80)]
    ev += marked("voxelize", 101, 150) + [Event("vox", 101, 150)]
    ev += marked("backbone", 161, 400) + marked("plan", 201, 260)
    ev += [Event("k2", 161, 200), Event("k3", 201, 260),
           Event("k4", 261, 300), Event("k5", 350, 400)]
    tl = tr.timeline(Prof(ev))
    seg = tl["segments"]
    assert seg["voxelize"]["total_s"] == pytest.approx(49e-6)
    assert seg["plan"]["self_s"] == pytest.approx(59e-6)
    # k2, plan's markers, plan, k4, k5: the idle 300-350 left out
    assert seg["backbone"]["total_s"] == pytest.approx(189e-6)
    assert seg["backbone"]["self_s"] == pytest.approx(130e-6)
    # the copy and the top segments' markers lie outside every segment
    assert tl["unsegmented_s"] == pytest.approx(34e-6)
    own = sum(v["self_s"] for v in seg.values())
    assert own + tl["unsegmented_s"] == pytest.approx(tl["busy_s"])
    assert tl["markers"] == 6 and tl["marker_s"] == pytest.approx(6e-6)
    assert all(v["paired"] == 1 and v["dropped"] == 0 for v in seg.values())
    per = tr.per_call(tl, 1)
    ctx = {"mode": "serve", "segments": per}
    assert tr.segment_ms(ctx, "serve", "backbone") == pytest.approx(0.130)
    assert tr.segment_ms(ctx, "serve", "backbone", nested=True) == \
        pytest.approx(0.189)
    assert tr.segment_ms(ctx, "train", "backbone") is None
    assert tr.segment_ms(ctx, "serve", "neck") is None


def test_a_lost_marker_drops_its_occurrence():
    ev = host(("step_call", 0, 1000))
    # call 1: voxelize's end lost; call 2 whole; then an end whose begin
    # was lost
    ev += [Event("mark_begin_voxelize", 100, 101), Event("vox", 101, 150)]
    ev += marked("voxelize", 501, 550) + [Event("vox", 501, 550)]
    ev += [Event("neck", 700, 750), Event("mark_end_neck", 750, 751)]
    tl = tr.timeline(Prof(ev))
    v = tl["segments"]["voxelize"]
    assert (v["paired"], v["dropped"]) == (1, 1)
    assert v["total_s"] == pytest.approx(49e-6)
    assert tl["segments"]["neck"] == {"total_s": 0.0, "self_s": 0.0,
                                      "paired": 0, "dropped": 1}
    per = tr.per_call(tl, 2)
    # the one paired occurrence stands for both calls' voxelize
    assert per["voxelize"]["self_ms"] == pytest.approx(0.049)
    assert "neck" not in per


def test_a_record_across_a_marker_is_clipped_to_the_segment():
    ev = host(("step_call", 0, 1000))
    ev += marked("neck", 101, 200)
    ev += [Event("other_stream_a", 50, 120), Event("other_stream_b", 180,
                                                   230)]
    tl = tr.timeline(Prof(ev))
    assert tl["segments"]["neck"]["total_s"] == pytest.approx(39e-6)


def test_idle_time_inside_a_segment_does_not_count():
    ev = host(("step_call", 0, 1000))
    ev += marked("bbox_head", 1, 101)
    ev += [Event("a", 1, 11), Event("b", 91, 101)]
    tl = tr.timeline(Prof(ev))
    assert tl["segments"]["bbox_head"]["total_s"] == pytest.approx(20e-6)


def test_gaps_take_the_innermost_span_and_annotations_are_not_busy():
    ev = host(("step_call", 0, 1000), ("step.stage_copy", 10, 60),
              ("step.launch", 60, 90))
    # the host spans' annotations on the device's rows
    ev += [Event("step_call", 0, 1000, annotation=True),
           Event("step.stage_copy", 10, 60, annotation=True)]
    ev += [Event("memcpyHtoD", 50, 80), Event("k", 500, 1000)]
    tl = tr.timeline(Prof(ev))
    assert tl["busy_s"] == pytest.approx(530e-6)
    labels = dict((round(s * 1e6), n) for n, s in tl["gaps"])
    assert labels == {50: "step.stage_copy", 420: "step_call"}


def test_a_program_span_reads_ms_a_call():
    ctx = {"mode": "serve", "program": {"step.stage_copy": (8, 0.016)}}
    assert tr.span_ms(ctx, "serve", "step.stage_copy") == pytest.approx(2.0)
    assert tr.span_ms(ctx, "train", "step.stage_copy") is None
    assert tr.span_ms(ctx, "serve", "step.stage_wait") is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,trace", [("tiny-second-serve-points", 0),
                                        ("tiny-second-serve-points", 1),
                                        ("tiny-second-train-points", 1)])
def test_only_trace_1_turns_the_programs_tracing_on(root, cell, trace,
                                                     capsys, monkeypatch):
    from det3d_tpu_torch.utils import trace as program
    calls = []
    real = program.enable

    def enable(on=True):
        calls.append(bool(on))
        real(on)
    monkeypatch.setattr(program, "enable", enable)
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 41),
                       "--seconds", "2", "--trace", str(trace)], root=root,
                      require_cuda=False)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    # on for the capture, off for the window, on for the stretch, off
    assert calls == ([True, False, True, False] if trace else [])
    assert not program.enabled()
