"""utils/trace.py on the CPU: the switch, spans and their totals, the one
list of segment names, and the segments the port's steps enter.

- Off (the default), ``span`` and ``segment`` are one shared no-op that
  records nothing; on, they nest in the profiler and add to ``totals()``.
- ``SEGMENTS`` holds utils/flops.py's ``STAGES`` (flops imports them).
- The eager predict and train steps of SECOND and CBGS (their shipped
  configs cut to +-6.4 m and 512 voxels, fed points alone, so the middle
  builds its plan on the device) enter, with tracing on, the segments in
  the order a step runs them, each under the segment open around it; on
  the CPU no marker is launched. Off, they enter none.
- ``ProfilerHook`` turns tracing on for the run and back after it, and
  writes the run's totals and marker launches beside its trace.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from det3d_tpu_torch.apis.train import build_stack, init_state
from det3d_tpu_torch.models.builder import init_weights
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.parallel.train import make_train_step
from det3d_tpu_torch.runtime import hooks
from det3d_tpu_torch.runtime.trainer import Trainer
from det3d_tpu_torch.utils import flops, trace
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_predict_graph import TRAIN_CFG

torch.set_num_threads(2)

CUT = (6.4, 512)
CONFIGS = {"second": cs.SECOND_CFG, "cbgs": cs.CBGS_CFG}

# (segment, the segment open around it) in the order a step enters them
PREDICT = [("voxelize", None), ("reader", None), ("backbone", None),
           ("plan", "backbone"), ("dense_tail", "backbone"), ("neck", None),
           ("bbox_head", None), ("decode+nms", None)]
TRAIN = [("voxelize", None), ("targets", None), ("reader", None),
         ("backbone", None), ("plan", "backbone"),
         ("dense_tail", "backbone"), ("neck", None), ("bbox_head", None),
         ("loss", None), ("backward", None), ("optimizer", None)]


@pytest.fixture
def tracing():
    """Tracing on with empty totals for the test, off after it."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def segment_tree(fn):
    """(name, innermost enclosing segment) of each segment ``fn`` enters,
    from torch.profiler's CPU events, in the order they start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = sorted((e for e in prof.events() if e.name in trace.SEGMENTS),
                 key=lambda e: (e.time_range.start, -e.time_range.end))
    out = []
    for e in evs:
        around = [p for p in evs if p is not e
                  and p.time_range.start <= e.time_range.start
                  and e.time_range.end <= p.time_range.end]
        parent = max(around, key=lambda p: p.time_range.start,
                     default=None)
        out.append((e.name, parent.name if parent is not None else None))
    return out


def stack(name):
    cfg = dict(cs.sparse_config(CONFIGS[name], cut=CUT), **TRAIN_CFG)
    model, vg, asg, cids, test_cfg = build_stack(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    return cfg, model, vg, asg, cids, test_cfg


def predict_step(name):
    cfg, model, vg, asg, cids, test_cfg = stack(name)
    pc = cfg["voxel_generator"]["range"]
    batch = (cs.cbgs_batch(2, 2000, pc, seed=3) if name == "cbgs"
             else structured_batch(2, 2000, pc, seed=3))
    return make_predict_step(model, vg, asg, cids, test_cfg), batch


# ---------------------------------------------------------------------------
# the switch, spans and totals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["span", "segment"])
def test_off_is_one_shared_no_op_that_records_nothing(kind):
    assert not trace.enabled()
    make = getattr(trace, kind)
    trace.reset()
    launches = trace.segment.launches
    ctx = make("voxelize")
    assert ctx is make("reader")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ctx:
            torch.ones(3).sum()
    assert "voxelize" not in {e.name for e in prof.events()}
    assert trace.totals() == {}
    assert trace.segment.launches == launches


def test_on_spans_nest_and_total(tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with trace.span("step.launch"):
                with trace.segment("decode+nms"):
                    torch.ones(3).sum()
    tot = trace.totals()
    assert set(tot) == {"step.launch", "decode+nms"}
    assert tot["step.launch"][0] == tot["decode+nms"][0] == 2
    assert tot["step.launch"][1] >= tot["decode+nms"][1] > 0
    inner = [e for e in prof.events() if e.name == "decode+nms"]
    assert len(inner) == 2
    assert all(e.cpu_parent is not None
               and e.cpu_parent.name == "step.launch" for e in inner)


def test_reset_clears_the_totals(tracing):
    with trace.span("step.outputs"):
        pass
    assert trace.totals()["step.outputs"][0] == 1
    trace.reset()
    assert trace.totals() == {}


def test_a_segment_is_one_of_the_one_list(tracing):
    with pytest.raises(ValueError):
        trace.segment("rpn")
    assert flops.STAGES is trace.STAGES
    assert trace.SEGMENTS[:len(trace.STAGES)] == trace.STAGES
    assert len(set(trace.SEGMENTS)) == len(trace.SEGMENTS)
    assert trace.marker_name("decode+nms") == "decode_nms"


def test_a_segment_on_the_cpu_launches_no_marker(tracing):
    launches = trace.segment.launches
    with trace.segment("plan"):
        torch.ones(3).cumsum(0)
    assert trace.segment.launches == launches
    assert trace.totals()["plan"][0] == 1


# ---------------------------------------------------------------------------
# the steps' segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["second", "cbgs"])
def test_predict_step_enters_the_stages_in_order(name, tracing):
    step, batch = predict_step(name)
    assert segment_tree(lambda: step(batch)) == PREDICT
    assert trace.totals()["decode+nms"][0] == 1


@pytest.mark.parametrize("name", ["second", "cbgs"])
def test_train_step_enters_the_segments_in_order(name, tracing):
    cfg, model, vg, asg, cids, _ = stack(name)
    state, _ = init_state(cfg, model, 10)
    step = make_train_step(state, vg, asg, cids)
    scans = cs.sparse_train_scene(name, 2, cfg["voxel_generator"]["range"],
                                  2000)
    assert segment_tree(lambda: step(scans)) == TRAIN
    assert int(state.step) == 1


def test_off_the_step_enters_no_segment():
    assert not trace.enabled()
    trace.reset()
    step, batch = predict_step("second")
    assert segment_tree(lambda: step(batch)) == []
    assert trace.totals() == {}


def test_stage_hooks_are_installed_once_a_model(tracing):
    """Two steps made on one model (a trainer's step and its evaluation's)
    enter each stage once, not once a step made."""
    cfg, model, vg, asg, cids, test_cfg = stack("second")
    first = trace.stage_hooks(model)
    assert len(first) == 8                  # a pre and a post hook a stage
    make_predict_step(model, vg, asg, cids, test_cfg)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    assert trace.stage_hooks(model) is first
    batch = structured_batch(2, 2000, cfg["voxel_generator"]["range"],
                             seed=3)
    assert segment_tree(lambda: step(batch)) == PREDICT


def test_profiler_hook_turns_tracing_on_for_the_run(tmp_path):
    seen = []

    def step(batch):
        seen.append(trace.enabled())
        return {"loss": batch["v"].sum()}

    tr = Trainer(None, step, work_dir=str(tmp_path))
    tr.register_hook(hooks.ProfilerHook(start=1, steps=1))
    data = [{"v": torch.ones(2)} for _ in range(3)]
    assert not trace.enabled()
    tr.run([data], [("train", 1)], 1)
    assert seen == [True] * 3
    assert not trace.enabled()


def test_profiler_hook_writes_the_run_totals_beside_its_trace(tmp_path):
    """The totals cover the whole run, not only the profiled iterations,
    and start from nothing at the run's start."""
    with trace.span("step.launch"):             # before the run: off
        pass
    trace.enable()
    with trace.span("step.capture"):            # on, before the run
        pass
    trace.enable(False)

    def step(batch):
        with trace.span("step.launch"):
            with trace.segment("loss"):
                loss = batch["v"].sum()
        return {"loss": loss}

    tr = Trainer(None, step, work_dir=str(tmp_path))
    tr.register_hook(hooks.ProfilerHook(start=1, steps=1))
    tr.run([[{"v": torch.ones(2)} for _ in range(3)]], [("train", 1)], 1)
    got = json.loads((tmp_path / "profile" / "trace_totals.json")
                     .read_text())
    assert (tmp_path / "profile" / "trace_1.json").is_file()
    assert set(got["spans"]) == {"step.launch", "loss"}
    assert got["spans"]["step.launch"][0] == got["spans"]["loss"][0] == 3
    assert got["spans"]["step.launch"][1] >= got["spans"]["loss"][1] > 0
    assert got["marker_launches"] == 0          # no marker on the CPU
    trace.reset()
