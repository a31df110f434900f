"""The CUDA kernels against their plain PyTorch twins, on the card: the
rotated-NMS keep mask and the sparse window convolution.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and
skip elsewhere (the check runs inside a fixture, so every worker collects
the same tests). Run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Keep masks must be exactly equal: the kernel repeats the plain version's
fp32 operations in order and is built with --fmad=false. The window conv
sums in another order: fp32 within rtol = atol = 1e-4; bf16 operands
against the plain version in fp32 on the same bf16-rounded operands,
within rtol = atol = 1e-3. TF32 is off.
"""

import numpy as np
import pytest
import torch

from chip_smoke import IOU_THR, nms_cases

pytestmark = pytest.mark.cuda

CASES = ("flagship N=8 K=1000", "K=333", "all invalid", "duplicates",
         "zero-size")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cases(dev):
    return nms_cases(dev)


@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain(cases, name):
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v = cases[name]
    keep = rotated_nms_keep(c, a, v, IOU_THR)
    torch.cuda.synchronize()
    ref = rotated_nms_keep_ref(c, a, v, IOU_THR)
    assert keep.dtype == torch.bool and keep.shape == v.shape
    assert torch.equal(keep, ref)
    # the CPU plain version agrees too on inputs clear of the threshold
    if name in ("flagship N=8 K=1000", "K=333", "duplicates"):
        cpu = rotated_nms_keep(c.cpu(), a.cpu(), v.cpu(), IOU_THR)
        assert torch.equal(keep.cpu(), cpu)


@pytest.mark.parametrize("k", [1, 63, 64, 65, 128])
def test_block_edges(dev, k):
    from chip_smoke import clustered_boxes, nms_inputs
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v = nms_inputs(clustered_boxes(2, k, k, n_objects=4),
                         np.ones((2, k), bool), dev)
    assert torch.equal(rotated_nms_keep(c, a, v, IOU_THR),
                       rotated_nms_keep_ref(c, a, v, IOU_THR))


def test_launch_counter(cases):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    c, a, v = cases["K=333"]
    before = rotated_nms_keep.launches
    rotated_nms_keep(c, a, v, IOU_THR)
    rotated_nms_keep(c.cpu(), a.cpu(), v.cpu(), IOU_THR)   # plain: no launch
    assert rotated_nms_keep.launches == before + 1


def test_wrapper_rejects_bad_inputs(cases):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    c, a, v = cases["K=333"]
    with pytest.raises(ValueError):
        rotated_nms_keep(c.double(), a, v, IOU_THR)
    with pytest.raises(ValueError):
        rotated_nms_keep(c, a, v.float(), IOU_THR)
    with pytest.raises(ValueError):
        rotated_nms_keep(c.transpose(0, 1), a, v, IOU_THR)
    with pytest.raises(ValueError):
        rotated_nms_keep(c, a.cpu(), v, IOU_THR)


def test_small_predict_card_post_processing_equals_cpu(dev):
    """The small flagship predict step runs on the card through the kernel,
    and the CPU post-processing (plain NMS) fed the card's head outputs
    gives the card's detections."""
    from det3d_tpu_torch.apis.flagship import flagship_config
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.builder import init_weights
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.parallel.predict import (build_example,
                                                  make_predict_step)
    from det3d_tpu_torch.utils.synth import structured_batch
    pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
    cfg = flagship_config(voxel_size=(0.2, 0.2, 4.0), pc_range=pc,
                          max_points=8, max_voxels=600, small=True)
    model, vg, asg, cids, test_cfg = build_stack(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    batch = structured_batch(2, 2000, pc, seed=3)
    before = rotated_nms_keep.launches
    out = make_predict_step(model, vg, asg, cids, test_cfg)(batch)
    assert rotated_nms_keep.launches == before + 1
    with torch.no_grad():
        ex = build_example({k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()}, vg, asg)
        heads = model(ex["voxels"], ex["num_points_per_voxel"],
                      ex["coordinates"])
        card = model.predict(ex, heads, test_cfg)
        ex_c = build_example({k: torch.as_tensor(v) for k, v in
                              batch.items()}, vg, asg)
        cpu = model.predict(ex_c, [{k: v.cpu() for k, v in h.items()}
                                   for h in heads], test_cfg)
    for k in ("valid", "label_preds"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
        assert torch.equal(out[k], card[k]), k
    torch.testing.assert_close(card["box3d_lidar"].cpu(), cpu["box3d_lidar"],
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def second_plan(dev):
    """SECOND's host plan of one structured scan at full scale."""
    from chip_smoke import POINTS, SEED, second_config, second_stack
    from det3d_tpu_torch.utils.synth import structured_batch
    batch = structured_batch(1, POINTS, second_config()["voxel_generator"][
        "range"], seed=SEED)
    return second_stack("cpu")[-1](batch["points"], batch["num_points"])


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["subm (4,16) s0", "strided (32,64) down2"])
def test_window_conv_equals_plain(dev, second_plan, prec, name):
    from chip_smoke import CONV_TOL, conv_cases
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    dtype = torch.float32 if prec == "fp32" else torch.bfloat16
    case = {c[0]: c for c in conv_cases(second_plan, dev, dtype)}[name]
    _, x, pk, w, subm = case
    before = window_conv.launches
    out = window_conv(x, pk, w, subm)
    torch.cuda.synchronize()
    assert window_conv.launches == before + 1
    r0, pres = unpack_windows(pk, 3)
    ref = window_conv_ref(x.float(), r0, pres, w.float(), subm)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, **CONV_TOL[prec])
    # the CPU plain version agrees too
    cpu = window_conv(x.cpu(), pk.cpu(), w.cpu(), subm)
    torch.testing.assert_close(out.cpu(), cpu, **CONV_TOL[prec])


def test_window_conv_rejects_bad_inputs(dev):
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    x = torch.zeros(1, 64, 16, device=dev)
    pk = torch.zeros(1, 64, 9, dtype=torch.int32, device=dev)
    w = torch.zeros(27, 16, 32, device=dev)
    with pytest.raises(ValueError):
        window_conv(x.bfloat16(), pk, w, True)          # mixed types
    with pytest.raises(ValueError):
        window_conv(x, pk.long(), w, True)
    with pytest.raises(ValueError):
        window_conv(x, pk, torch.zeros(27, 16, 24, device=dev), True)
    with pytest.raises(ValueError):
        window_conv(x, pk[:, :32], w, True)             # O != V
    with pytest.raises(ValueError):
        window_conv(x, pk.cpu(), w, True)
