"""The control, at a size a test run holds: the reference computed in
bf16 in the program's place fails the cells' limits, and so does the
fault of half the training batch left out."""

import json

import pytest
import torch

from benchmark.core import judge, traffic, weights
from benchmark.core.train import CHECKED_STEPS, reference_steps
from benchmark.reference import voxelnet as R
from benchmark.tests import tiny


def limits(cell):
    return {k: v["limit"] for k, v in json.loads(
        (tiny.BENCH / "limits" / f"{cell}.json").read_text()).items()}


def setup(name, mix):
    cfg, m = tiny.tiny_config(name), tiny.tiny_mix(mix)
    pool = traffic.pool(m, cfg, 2 ** 31 + 77)
    arch = R.Arch(cfg)
    params = weights.make_params(arch, 5, "cpu")
    b = pool[0]
    weights.calibrate(R, arch, params, torch.as_tensor(b["points"][:1]),
                      torch.as_tensor(b["num_points"][:1]))
    return cfg, arch, params, pool


@pytest.mark.parametrize("name,mix,cell", [
    ("second-kitti-car", "serve-points-16k", "second-serve-points"),
    ("cbgs-nusc", "serve-points-300k-sweeps", "cbgs-serve-points")])
def test_the_bf16_control_fails_the_serving_limit(name, mix, cell):
    cfg, arch, params, pool = setup(name, mix)
    b = pool[0]
    pts, n = torch.as_tensor(b["points"]), torch.as_tensor(b["num_points"])
    with torch.no_grad():
        ref = R.forward(arch, params, pts, n)[0]
        ctl = R.forward(arch, params, pts, n, dtype=torch.bfloat16)[0]
    assert judge.head_gap(ctl, ref) > limits(cell)["head_gap"]


@pytest.mark.parametrize("name,mix,cell", [
    ("second-kitti-car", "train-points-16k", "second-train-points")])
def test_the_bf16_control_and_half_batch_fail_the_training_limits(
        name, mix, cell):
    cfg, arch, params, pool = setup(name, mix)
    names = [n for n, _, kind, _ in arch.param_spec()
             if kind in ("w", "b", "scale", "shift")]
    dev = torch.device("cpu")
    batches = pool[:CHECKED_STEPS]
    ref, _ = reference_steps(R, arch, cfg, params, names, batches, 100, dev)
    lim = limits(cell)
    for kind in ("bf16", "half"):
        if kind == "bf16":
            got, _ = reference_steps(R, arch, cfg, params, names, batches,
                                     100, dev, dtype=torch.bfloat16)
        else:
            got, _ = reference_steps(
                R, arch, cfg, params, names,
                [{k: v[:1] for k, v in x.items()} for x in batches], 100,
                dev)
        nums = judge.train_numbers(got, ref)
        assert any(nums[k] > lim[k] for k in lim), (kind, nums)


def test_the_control_refuses_to_run_without_a_card(monkeypatch, capsys):
    from benchmark import control
    monkeypatch.setattr(control.harness, "set_environment", lambda root: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control.main(["--workload", "second-serve-points",
                         "--seeds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "is_available() is false" in out.err
