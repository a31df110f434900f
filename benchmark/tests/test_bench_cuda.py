"""On the card: a tiny cut of each cell through the real harness path
(the chip's look, the captured steps, the profiler), sound and correct,
and the bf16 control failing at the card's arithmetic. Skipped where no
card is (decided in a fixture)."""

import json

import pytest
import torch

from benchmark.core import harness, judge, traffic, weights
from benchmark.reference import voxelnet as R
from benchmark.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-second-serve-points",
                                  "tiny-cbgs-serve-points",
                                  "tiny-second-train-points"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_correct_on_the_card(card, root, cell, trace,
                                              capsys):
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 31 + 5),
                       "--seconds", "1", "--trace", str(trace)], root=root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_the_bf16_control_fails_on_the_card(card):
    cfg = tiny.tiny_config("second-kitti-car")
    b = traffic.pool(tiny.tiny_mix("serve-points-16k"), cfg, 3)[0]
    arch = R.Arch(cfg)
    params = weights.make_params(arch, 3, card)
    pts = torch.as_tensor(b["points"], device=card)
    n = torch.as_tensor(b["num_points"], device=card)
    weights.calibrate(R, arch, params, pts[:1], n[:1])
    with torch.no_grad():
        ref = R.forward(arch, params, pts, n)[0]
        ctl = R.forward(arch, params, pts, n, dtype=torch.bfloat16)[0]
    lim = json.loads((tiny.BENCH / "limits" / "second-serve-points.json")
                     .read_text())["head_gap"]["limit"]
    assert judge.head_gap(ctl, ref) > lim
