"""The port's serving slice end to end against the JAX package, on the CPU.

``__graft_entry__._build_flagship(small=True)`` (random weights, random
BatchNorm statistics) on B=2 structured scans, against the port's stack
built by ``build_stack`` from the same configuration:

- head outputs agree within rtol = atol = 1e-4 (fp32, sums in other orders);
- the port's post-processing fed JAX's head outputs gives JAX's detections:
  the same valid mask and labels, boxes and scores within 1e-5 (decode
  rounds exp/sin differently in the last bit);
- the port's whole predict step gives the same valid mask, with boxes and
  scores within 1e-4.

Exact agreement of the detection set needs every score that decides it to
sit clear of fp32 noise. The class logits are spread out (kernel x20, bias
-8) so that a few dozen candidates per scan pass the score threshold, and
the batch's seed is chosen so that no score lies within 1e-4 of
``score_threshold`` or of the ``nms_pre_max_size`` cut; the test asserts
it.

A subprocess runs the port's slice and checks that neither jax nor flax
was imported.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _build_flagship
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.utils.synth import structured_batch
from det3d_tpu_torch.apis.flagship import TEST_CFG, flagship_config
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.parallel.predict import build_example, make_predict_step
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import PC, SMALL, randomize

torch.set_num_threads(2)

HEAD_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
SEED = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run():
    model, vg, assigners, class_ids = _build_flagship(small=True, **SMALL)
    batch = structured_batch(2, 2000, PC, seed=SEED)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ex = jbuild_example(jbatch, vg, assigners, class_ids, with_targets=False)
    init = model.init(jax.random.PRNGKey(0), ex["voxels"],
                      ex["num_points_per_voxel"], ex["coordinates"],
                      train=False)
    var = randomize(init, 1)
    cls = var["params"]["bbox_head"]["task_0"]["conv_cls"]
    cls["kernel"] = cls["kernel"] * 20.0
    cls["bias"] = np.full_like(cls["bias"], -8.0)
    heads = jax.jit(lambda v, e: model.apply(
        v, e["voxels"], e["num_points_per_voxel"], e["coordinates"],
        train=False))(var, ex)
    det = jax.jit(lambda e, p: model.predict(e, p, TEST_CFG))(ex, heads)

    tmodel, tvg, tasg, tcids, test_cfg = build_stack(
        flagship_config(small=True, **SMALL), device="cpu")
    tmodel.load_state_dict(from_jax(var["params"], var["batch_stats"]))
    step = make_predict_step(tmodel, tvg, tasg, tcids, test_cfg)
    tex = build_example({k: torch.from_numpy(v) for k, v in batch.items()},
                        tvg, tasg)
    with torch.no_grad():
        theads = tmodel(tex["voxels"], tex["num_points_per_voxel"],
                        tex["coordinates"])
        jheads_t = [{k: torch.from_numpy(np.array(v)) for k, v in h.items()}
                    for h in heads]
        tdet_from_jax = tmodel.predict(tex, jheads_t, test_cfg)
    return dict(
        heads=jax.tree_util.tree_map(np.asarray, heads),
        det={k: np.asarray(v) for k, v in det.items()},
        theads=theads, tdet_from_jax=tdet_from_jax,
        tdet=step(batch))


def test_scores_clear_of_the_cuts(run):
    """No score within MARGIN of the score threshold or of the top-k cut."""
    scores = 1.0 / (1.0 + np.exp(-run["heads"][0]["cls_preds"].astype(
        np.float64).reshape(2, -1)))
    assert np.abs(scores - TEST_CFG["score_threshold"]).min() > MARGIN
    k = TEST_CFG["nms"]["nms_pre_max_size"]
    srt = -np.sort(-scores, axis=1)
    n_valid = (scores >= TEST_CFG["score_threshold"]).sum(axis=1)
    assert (n_valid > 10).all()
    # the top-k cut either keeps every valid candidate or falls in a gap
    assert ((n_valid <= k) | (srt[:, k - 1] - srt[:, k] > MARGIN)).all()


def test_head_outputs_match(run):
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        np.testing.assert_allclose(run["theads"][0][k].numpy(),
                                   run["heads"][0][k], err_msg=k, **HEAD_TOL)


def test_post_processing_of_jax_heads_equals_jax(run):
    det, tdet = run["det"], run["tdet_from_jax"]
    np.testing.assert_array_equal(tdet["valid"].numpy(), det["valid"])
    np.testing.assert_array_equal(tdet["label_preds"].numpy(),
                                  det["label_preds"])
    np.testing.assert_allclose(tdet["box3d_lidar"].numpy(),
                               det["box3d_lidar"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tdet["scores"].numpy(), det["scores"],
                               rtol=0, atol=1e-5)
    n_valid = det["valid"].sum(axis=1)
    assert (n_valid > 0).all() and (n_valid < det["valid"].shape[1]).all()


def test_predict_step_matches_jax(run):
    det, tdet = run["det"], run["tdet"]
    assert tdet["box3d_lidar"].shape == det["box3d_lidar"].shape == (2, 100, 7)
    np.testing.assert_array_equal(tdet["valid"].numpy(), det["valid"])
    v = det["valid"]
    np.testing.assert_allclose(tdet["box3d_lidar"].numpy()[v],
                               det["box3d_lidar"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tdet["scores"].numpy()[v], det["scores"][v],
                               rtol=0, atol=1e-4)


def test_slice_imports_neither_jax_nor_flax():
    code = textwrap.dedent("""
        import sys
        import torch
        from det3d_tpu_torch.apis.flagship import flagship_config
        from det3d_tpu_torch.apis.train import build_stack
        from det3d_tpu_torch.models.builder import init_weights
        from det3d_tpu_torch.parallel.predict import make_predict_step
        from det3d_tpu_torch.utils import convert  # noqa: F401
        from det3d_tpu_torch.utils.synth import structured_batch

        pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
        cfg = flagship_config(voxel_size=(0.2, 0.2, 4.0), pc_range=pc,
                              max_points=8, max_voxels=300, small=True)
        model, vg, asg, cids, test_cfg = build_stack(cfg, device="cpu")
        init_weights(model, torch.Generator().manual_seed(0))
        out = make_predict_step(model, vg, asg, cids, test_cfg)(
            structured_batch(1, 800, pc, seed=0))
        assert out["box3d_lidar"].shape == (1, 100, 7)
        assert "jax" not in sys.modules, "jax was imported"
        assert "flax" not in sys.modules, "flax was imported"
        assert "det3d_tpu" not in sys.modules, "det3d_tpu was imported"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
