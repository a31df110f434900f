"""A whole run on the CPU at a tiny size, the chip's look skipped: sound,
it comes out correct; with the timed path broken underneath, correct
comes out false, for each fault a cell can have (serving: a step that
returns its last answer unchanged, half of the batch left out, an answer
altered where it is produced; training: the state left unchanged, half
of the batch left out, the mean taken over the rest). One chip, so no
exchange between chips to leave out."""

import json

import numpy as np
import pytest
import torch

from benchmark.core import harness
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_tree(tmp_path_factory.mktemp("bench"))


def run(root, cell, capsys, seed=2 ** 31 + 21):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "2", "--trace", "0"], root=root,
                      require_cuda=False)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def broken_predict(monkeypatch, kind):
    import det3d_tpu_torch.parallel.predict as pp
    real = pp.make_predict_step

    def make(*a, **k):
        step = real(*a, **k)
        last = {}

        def fn(batch):
            if kind == "stale" and last:
                out = last["out"]
                step(batch)                 # the head runs, its answer dropped
                return out
            if kind == "half":
                # the second half left out: the first half served twice
                b = batch["points"].shape[0] // 2
                return step({k: np.concatenate([v[:b], v[:b]])
                             for k, v in batch.items()})
            out = step(batch)
            if kind == "altered":
                out = dict(out)
                box = out["box3d_lidar"].clone()
                box[:, 0, 0] += 0.5
                out["box3d_lidar"] = box
                out["valid"] = out["valid"].clone()
                out["valid"][:, 0] = True
            last["out"] = out
            return out
        return fn
    monkeypatch.setattr(pp, "make_predict_step", make)


@pytest.mark.parametrize("cell", ["tiny-second-serve-points",
                                  "tiny-cbgs-serve-points"])
def test_a_sound_serving_run_is_correct(root, cell, capsys):
    line = run(root, cell, capsys)
    assert line["correct"] is True
    assert list(line)[-1] == "compared"
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_a_broken_serving_step_is_not_correct(root, kind, capsys,
                                              monkeypatch):
    broken_predict(monkeypatch, kind)
    line = run(root, "tiny-second-serve-points", capsys)
    assert line["correct"] is False


def broken_train(monkeypatch, kind):
    import det3d_tpu_torch.parallel.train as pt
    import det3d_tpu_torch.solver.optim as opt
    if kind == "unchanged":
        monkeypatch.setattr(opt.Optimizer, "update",
                            lambda self, grads: torch.zeros(()))
        return
    real = pt.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def fn(batch):
            b = batch["points"].shape[0] // 2
            return step({k: v[:b] for k, v in batch.items()})
        return fn
    monkeypatch.setattr(pt, "make_train_step", make)


@pytest.mark.parametrize("cell", ["tiny-second-train-points"])
def test_a_sound_training_run_is_correct(root, cell, capsys):
    assert run(root, cell, capsys)["correct"] is True


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_a_broken_train_step_is_not_correct(root, kind, capsys,
                                            monkeypatch):
    broken_train(monkeypatch, kind)
    assert run(root, "tiny-second-train-points", capsys)["correct"] is False
