"""The port's config-driven train / resume / eval on the synthetic
mini-KITTI, on the CPU (``device="cpu"``): the counterpart of
tests/test_apis.py. Each component is held to the JAX package's in
tests/test_torch_kitti_data.py and tests/test_torch_runtime.py; here the
public entry points drive them together."""

import os

import numpy as np
import pytest
import torch

from det3d_tpu_torch.apis.train import eval_detector, train_detector
from det3d_tpu_torch.runtime.checkpoint import state_tensors
from det3d_tpu_torch.utils import mini_kitti as mk


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("apis_kitti")
    gt = mk.make_tree(root, n_scenes=8)
    return root, gt


def test_train_resume_eval(tree, tmp_path_factory, capsys):
    root, _ = tree
    work = tmp_path_factory.mktemp("work")
    cfg = mk.mini_config(str(root), total_epochs=2)
    cfg["tensorboard"] = True
    trainer = train_detector(cfg, work_dir=str(work), device="cpu")
    assert trainer.epoch == 2 and trainer.iter == 4
    assert sorted(os.listdir(work / "ckpt")) == [
        "det3d_tpu_meta.json", "epoch_1.pt", "epoch_2.pt"]
    assert list((work / "tf_logs").glob("events.out.tfevents.*"))
    assert list(work.glob("*.log.json"))

    # resume continues the epoch counter and writes into the new state
    cfg["total_epochs"] = 3
    trainer2 = train_detector(cfg, work_dir=str(work),
                              resume_from=str(work), device="cpu")
    assert trainer2.epoch == 3
    # the optimizer's step count matches the trainer's global iter counter
    assert int(trainer2.state.step) == trainer2.iter == 6
    for v in state_tensors(trainer2.state).values():
        assert torch.isfinite(v.float()).all()

    # the tail batch is padded by its last example: B=3 over 4 val scans
    cfg["data"]["samples_per_gpu"] = 3
    results, dets = eval_detector(cfg, trainer2.state, work_dir=str(work),
                                  device="cpu")
    assert "Car_3d_easy" in results["detail"]["eval.kitti"]["official"]
    assert sorted(dets) == ["4", "5", "6", "7"]     # every val token
    assert (work / "kitti_eval.txt").is_file()
    for d in dets.values():
        n = len(d["scores"])
        assert d["box3d_lidar"].shape == (n, 7) and n <= 48
        assert np.isfinite(d["box3d_lidar"]).all()

    cfg["data"]["samples_per_gpu"] = 1
    _, dets1 = eval_detector(cfg, trainer2.state, device="cpu")
    assert "Total time per frame" in capsys.readouterr().out
    for t in dets:
        np.testing.assert_allclose(dets1[t]["scores"], dets[t]["scores"],
                                   rtol=0, atol=1e-5)


def test_train_eval_sparse_with_host_plan(tree, tmp_path_factory):
    """SECOND-family train/eval through the public API with the HostPlan
    stage injected and two fork workers: the fast twin of the sparse
    learning gate."""
    root, _ = tree
    work = tmp_path_factory.mktemp("work_sp")
    cfg = mk.mini_second_config(str(root), total_epochs=1, workers=2)
    cfg["checkpoint_interval"] = 10
    cfg["log_interval"] = 1
    trainer = train_detector(cfg, work_dir=str(work), device="cpu")
    stages = [p.get("type") for p in cfg["data"]["train"]["pipeline"]]
    assert stages[-1] == "HostPlan"
    assert cfg["data"]["train"]["pipeline"][-1]["train"] is True
    assert trainer.iter == int(trainer.state.step) == 2
    log = open(next(work.glob("*.log.json"))).read()
    assert '"loss"' in log and "NaN" not in log

    results, dets = eval_detector(cfg, trainer.state, work_dir=str(work),
                                  device="cpu")
    assert "Car_3d_easy" in results["detail"]["eval.kitti"]["official"]
    assert sorted(dets) == ["4", "5", "6", "7"]
    val = cfg["data"]["val"]["pipeline"][-1]
    assert val["type"] == "HostPlan" and val["train"] is False


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_need_a_card_unless_asked_for_the_cpu(tree, tmp_path):
    root, _ = tree
    cfg = mk.mini_config(str(root), total_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detector(cfg, work_dir=str(tmp_path))
    trainer = train_detector(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_detector(cfg, trainer.state)
