"""The learning-quality gates of tests/test_learning_quality.py, on the
port, on the card.

The same recipe and thresholds: the synthetic mini-KITTI tree of 16
scenes (utils/mini_kitti.py), 150 epochs at B=2 on 2 loader workers,
``scale_batch_by_devices=False``, then the official KITTI evaluation of
the val split. PointPillars (bf16 reader and neck) must reach
Car_3d_easy_loose > 70 and Car_bbox_easy > 40, SECOND (the sparse middle
fed host training plans) > 60 and > 40. They carry ``slow`` and
``cuda``: tier-1 skips them, and they skip without a card. On the card:

    python -m pytest --noconftest tests/test_torch_learning_quality.py \
        -m "slow and cuda"

(``--noconftest`` keeps tests/conftest.py's JAX set-up out of a run that
needs only torch.) chip_smoke.py's phase 66 runs the same two gates.
"""

import pytest
import torch

from det3d_tpu_torch.apis.train import eval_detector, train_detector
from det3d_tpu_torch.utils import mini_kitti as mk

pytestmark = [pytest.mark.slow, pytest.mark.cuda]

GATES = {"pointpillars": (mk.mini_config, 70.0, 40.0),
         "second": (mk.mini_second_config, 60.0, 40.0)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("name", sorted(GATES))
def test_trains_to_detection_quality(card, name, tmp_path_factory):
    config, need_3d, need_bbox = GATES[name]
    root = tmp_path_factory.mktemp(f"learn_kitti_{name}")
    mk.make_tree(root, n_scenes=16)
    cfg = config(str(root), total_epochs=150, workers=2)
    cfg["checkpoint_interval"] = 150
    cfg["log_interval"] = 100
    # the global batch pinned to 2: the gate anchors to the 600-step recipe
    cfg["scale_batch_by_devices"] = False
    work = tmp_path_factory.mktemp(f"learn_work_{name}")
    trainer = train_detector(cfg, work_dir=str(work))
    assert trainer.iter == int(trainer.state.step) == 600
    results, _ = eval_detector(cfg, trainer.state, work_dir=str(work))
    detail = results["detail"]["eval.kitti"]["official"]
    # loose-overlap 3D AP (IoU 0.5): the model must genuinely detect
    assert detail["Car_3d_easy_loose"] > need_3d, detail
    # and the strict bbox AP shows localization, not box spam
    assert detail["Car_bbox_easy"] > need_bbox, detail
