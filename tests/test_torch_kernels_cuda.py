"""The CUDA kernels against their plain PyTorch twins, on the card: the
rotated-NMS keep mask and the sparse window convolution.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker and
skip elsewhere (the check runs inside a fixture, so every worker collects
the same tests). Run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Keep masks must be exactly equal: the kernel repeats the plain version's
fp32 operations in order and is built with --fmad=false, and culls only
pairs whose IoU is exactly 0. They are held at five thresholds, on
near-touching boxes, one cluster, CBGS's 12 samples, K from 1 to the
wrapper's limit. The window conv
sums in another order: fp32 (the CUDA-core kernel) within rtol = atol =
1e-4; bf16 (the tensor-core kernel) against the plain version in fp32 on
the same bf16-rounded operands, within rtol = atol = 1e-3, at SECOND's
shapes, at CBGS's stem and transition at 60000 rows, and on edge cases in
both precisions: ragged tiles, taps in one row of a tile, center taps at
tile edges, windows past V, Cin from 4 to 128 and Cout 16 to 128, the
(3, 1, 1) z conv, unaligned features. The fp32 kernel's geometry equals
the CPU model of its schedule (ops/window_conv_cuda.py::f32_schedule). The NMS kernel is also
held on the nuScenes PointPillars step's own inputs, and the appearance-
order device voxelizer against its host twin at that step's 300000-point
scans (exact: integer and copy operations). The window conv's backward
kernels (csrc/window_conv_bwd.cu) are held within chip_smoke.py's
BWD_TOL of their twins at every conv the training paths run (SECOND,
CBGS with its Cin-5 and Lyft's Cin-6 stem, RCNN, VoxelNet's (128, 16)
stem, kz-7 windows), the same bits on a second call and on a CUDA-graph
replay, and their geometry and grid order equal to the CPU models that
tests/test_torch_bwd_schedule.py holds to JAX's plans. TF32 is off.
"""

import numpy as np
import pytest
import torch

from chip_smoke import IOU_THR, NMS_THRESHOLDS, nms_cases, nms_large_cases

pytestmark = pytest.mark.cuda

CASES = ("flagship N=8 K=1000", "K=333", "SECOND N=2 K=1000",
         "CBGS N=12 K=1000", "one cluster", "touching", "all invalid",
         "duplicates", "zero-size")


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
    """{threshold: nms_cases at that threshold}, built once."""
    return {thr: nms_cases(dev, thr) for thr in NMS_THRESHOLDS}


@pytest.mark.parametrize("thr", NMS_THRESHOLDS)
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain(cases, name, thr):
    """Exact keep masks at SECOND's, nuScenes', the flagship's and a
    stricter threshold (the kernel culls far pairs), and at a negative one
    (it culls none)."""
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v = cases[thr][name]
    keep = rotated_nms_keep(c, a, v, thr)
    torch.cuda.synchronize()
    ref = rotated_nms_keep_ref(c, a, v, thr)
    assert keep.dtype == torch.bool and keep.shape == v.shape
    assert torch.equal(keep, ref)
    # the CPU plain version agrees too on inputs clear of the threshold
    if name in ("flagship N=8 K=1000", "K=333", "duplicates"):
        cpu = rotated_nms_keep(c.cpu(), a.cpu(), v.cpu(), thr)
        assert torch.equal(keep.cpu(), cpu)


@pytest.mark.parametrize("thr", [0.01, IOU_THR])
def test_large_k(dev, thr):
    """K=4096 and K at the wrapper's limit (MAX_K): the scan's ring at its
    largest."""
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    for name, (c, a, v) in nms_large_cases(dev, thr).items():
        keep = rotated_nms_keep(c, a, v, thr)
        torch.cuda.synchronize()
        assert torch.equal(keep, rotated_nms_keep_ref(c, a, v, thr)), name


def test_k_above_limit_raises(dev):
    from det3d_tpu_torch.ops.nms_cuda import MAX_K, rotated_nms_keep
    k = MAX_K + 1
    c = torch.zeros(1, k, 8, device=dev)
    with pytest.raises(ValueError, match=f"limit of {MAX_K}"):
        rotated_nms_keep(c, torch.zeros(1, k, device=dev),
                         torch.ones(1, k, dtype=torch.bool, device=dev),
                         IOU_THR)


def test_samples_past_grid_y_limit(cases):
    """N = 70000 samples, more than a grid's y axis holds (65535): the mask
    kernel puts the samples on x and its three tiles (K=65) on y. Each
    sample is one of the two of the K=65 case, so each keep row equals the
    plain twin's of that sample."""
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v = cases[IOU_THR]["K=65"]
    reps = 35000
    keep = rotated_nms_keep(c.repeat(reps, 1, 1), a.repeat(reps, 1),
                            v.repeat(reps, 1), IOU_THR)
    torch.cuda.synchronize()
    ref = rotated_nms_keep_ref(c, a, v, IOU_THR)
    assert keep.shape == (2 * reps, 65)
    assert torch.equal(keep, ref.repeat(reps, 1))


@pytest.mark.parametrize("k", [1, 63, 64, 65, 128])
def test_block_edges(cases, k):
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    c, a, v = cases[IOU_THR][f"K={k}"]
    assert torch.equal(rotated_nms_keep(c, a, v, IOU_THR),
                       rotated_nms_keep_ref(c, a, v, IOU_THR))


def test_launch_counter(cases):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    c, a, v = cases[IOU_THR]["K=333"]
    before = rotated_nms_keep.launches
    rotated_nms_keep(c, a, v, IOU_THR)
    rotated_nms_keep(c.cpu(), a.cpu(), v.cpu(), IOU_THR)   # plain: no launch
    assert rotated_nms_keep.launches == before + 1


def test_wrapper_rejects_bad_inputs(cases):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    c, a, v = cases[IOU_THR]["K=333"]
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
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    before = rotated_nms_keep.launches
    out = step.eager(batch)
    assert rotated_nms_keep.launches == before + 1
    captured = step(batch)
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
        assert torch.equal(captured[k], card[k]), k
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


CONV_SHAPES = ("subm (4,16) s0", "subm (16,16) s0", "strided (16,32) down1",
               "subm (32,32) subm1", "strided (32,64) down2",
               "subm (64,64) subm2", "strided (64,64) down3")


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", CONV_SHAPES)
def test_window_conv_equals_plain(dev, second_plan, prec, name):
    """Every (Cin, Cout, center_shift) of SECOND's middle, on its plan: the
    bf16 tensor-core kernel and the fp32 CUDA-core kernel."""
    from chip_smoke import CONV_TOL, SECOND_SPARSE, conv_cases
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    dtype = torch.float32 if prec == "fp32" else torch.bfloat16
    case = {c[0]: c for c in conv_cases(second_plan, dev, dtype,
                                        SECOND_SPARSE)}[name]
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


@pytest.fixture(scope="module")
def cbgs_plan(dev):
    """CBGS's host plan of one structured scan at full scale (300000
    points, 60000 voxels)."""
    from chip_smoke import CBGS_POINTS, cbgs_batch, cbgs_config, plan_builder
    cfg = cbgs_config()
    batch = cbgs_batch(1, CBGS_POINTS, cfg["voxel_generator"]["range"])
    return plan_builder(cfg)(batch["points"], batch["num_points"])


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["subm (5,16) s0", "strided (32,64) down2"])
def test_window_conv_cbgs_equals_plain(dev, cbgs_plan, prec, name):
    """CBGS's stem (Cin 5, zero-padded in bf16) and its transition into the
    dense tail, at V = O = 60000 rows."""
    from chip_smoke import CBGS_SPARSE, CONV_TOL, conv_cases
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    dtype = torch.float32 if prec == "fp32" else torch.bfloat16
    case = {c[0]: c for c in conv_cases(cbgs_plan, dev, dtype,
                                        CBGS_SPARSE)}[name]
    _, x, pk, w, subm = case
    assert x.shape[1] == pk.shape[1] == 60000
    out = window_conv(x, pk, w, subm)
    torch.cuda.synchronize()
    r0, pres = unpack_windows(pk, 3)
    ref = window_conv_ref(x.float(), r0, pres, w.float(), subm)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert int(pres.sum()) > 60000
    torch.testing.assert_close(out, ref, **CONV_TOL[prec])


def test_cbgs_fused_nms_equals_plain(dev):
    """CBGS's 6-task head post-processing on the card, fed random head
    outputs at the shipped (1, 128, 128) map: the tasks fused into N = 2 x
    6 samples of K = 1000 candidates at thr 0.2 go through the kernel once,
    whose keep masks equal the plain twin's on those inputs."""
    from chip_smoke import cbgs_config, step_nms_inputs
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    model, _, asg, cids, test_cfg = build_stack(cbgs_config(), device=dev)
    head = model.bbox_head
    r = np.random.RandomState(0)
    heads = []
    for nc, na in zip(head.num_classes, head.num_anchor_per_locs):
        heads.append({
            "box_preds": r.normal(0, 0.1, (2, 128, 128, na * 10)),
            "cls_preds": r.normal(-1.0, 1.5, (2, 128, 128, na * nc))})
    heads = [{k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in h.items()} for h in heads]
    ex = {"anchors": [a.anchors_on(dev)[None].expand(2, -1, -1)
                      for a in asg]}
    before = rotated_nms_keep.launches
    out = model.predict(ex, heads, test_cfg)
    torch.cuda.synchronize()
    assert rotated_nms_keep.launches == before + 1
    assert out["box3d_lidar"].shape == (2, 6 * 83, 9)
    assert bool(torch.isfinite(out["box3d_lidar"]).all())
    assert int(out["valid"].sum()) > 0
    c, a, v, thr = step_nms_inputs(lambda: model.predict(ex, heads,
                                                         test_cfg))
    assert c.shape[:2] == (2 * len(cids), 1000) and thr == 0.2
    keep = rotated_nms_keep(c, a, v, thr)
    torch.cuda.synchronize()
    assert torch.equal(keep, rotated_nms_keep_ref(c, a, v, thr))
    assert 0 < int(keep.sum()) < int(v.sum())


def test_appearance_voxelizer_equals_host_twin_at_bench_size(dev):
    """nuScenes PointPillars' voxelizer (appearance order, 30000 pillars of
    20 points) on the card, on the bench row's B=2 x 300000 points, which
    overflow the pillar cap: the host twin's voxels, coords, counts and
    num_voxels, exactly."""
    from chip_smoke import (CBGS_B, CBGS_POINTS, NUSC_PP_CFG, pp_config,
                            pp_scans)
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.ops.voxelize_host import host_voxelize_batch
    cfg = pp_config(NUSC_PP_CFG)
    vg = build_stack(cfg, device="cpu")[1]
    assert vg.order == "appearance" and not vg.fuse_mean
    batch = pp_scans(cfg, CBGS_B, CBGS_POINTS)
    out = vg.generate_batch(torch.as_tensor(batch["points"], device=dev),
                            torch.as_tensor(batch["num_points"], device=dev))
    torch.cuda.synchronize()
    host = host_voxelize_batch(batch["points"], batch["num_points"], vg)
    for k, hk in (("voxels", "voxels"), ("coords", "coordinates"),
                  ("num_points_per_voxel", "num_points_per_voxel"),
                  ("num_voxels", "num_voxels")):
        np.testing.assert_array_equal(out[k].cpu().numpy(), host[hk],
                                      err_msg=k)
    assert (host["num_voxels"] == vg.max_voxels).all()


def test_nms_on_nusc_pointpillars_step_inputs_equals_plain(dev):
    """What the nuScenes PointPillars predict step (B=2 x 300000 points,
    host voxels, bf16 reader and neck) feeds the NMS kernel: N = 2 x 6
    samples of K = 1000 at thr 0.2, whose keep masks equal the plain
    twin's."""
    from chip_smoke import (CBGS_B, CBGS_POINTS, NUSC_PP_CFG, pp_config,
                            pp_scans, pp_stack, step_nms_inputs)
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    from det3d_tpu_torch.parallel.predict import make_predict_step
    batch = pp_scans(pp_config(NUSC_PP_CFG), CBGS_B, CBGS_POINTS)
    model, vg, asg, cids, test_cfg, vox_fn = pp_stack(NUSC_PP_CFG, dev)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    data = dict(batch, **vox_fn(batch["points"], batch["num_points"]))
    c, a, v, thr = step_nms_inputs(lambda: step.eager(data))
    assert c.shape[:2] == (CBGS_B * 6, 1000) and thr == 0.2
    keep = rotated_nms_keep(c, a, v, thr)
    torch.cuda.synchronize()
    assert torch.equal(keep, rotated_nms_keep_ref(c, a, v, thr))
    assert 0 < int(keep.sum()) < int(v.sum())


def random_words(o, v, seed, density=0.3, k=9):
    """(1, O, K) packed words: each (row, column) present with probability
    ``density``, 1-7 presence bits, r0 anywhere in [0, V + 2] (windows
    that start at or run past V clamp and read zero there)."""
    r = np.random.RandomState(seed)
    r0 = r.randint(0, v + 3, size=(1, o, k))
    bits = r.randint(1, 8, size=(1, o, k)) * (r.uniform(size=(1, o, k))
                                              < density)
    return (r0 | (bits << 24)).astype(np.int32)


def conv_against_plain(dev, packed, v, cin, cout, center_shift, prec,
                       seed=0, x=None):
    """The kernel in ``prec`` on ``packed`` against the plain version in
    fp32 on the same operands (bf16: rounded to bf16), within
    CONV_TOL[prec]; returns the plain output."""
    from chip_smoke import CONV_TOL, DTYPES
    from det3d_tpu_torch.ops.sparse import unpack_windows
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv,
                                                      window_conv_ref)
    r = np.random.RandomState(seed)
    pk = torch.as_tensor(packed, device=dev)
    if x is None:
        x = torch.as_tensor(r.randn(pk.shape[0], v, cin).astype(np.float32),
                            device=dev).to(DTYPES[prec])
    kvol = 3 * pk.shape[-1]
    w = torch.as_tensor((r.randn(kvol, cin, cout) / (kvol * cin) ** 0.5)
                        .astype(np.float32), device=dev).to(DTYPES[prec])
    out = window_conv(x, pk, w, center_shift)
    torch.cuda.synchronize()
    r0, pres = unpack_windows(pk, 3)
    ref = window_conv_ref(x.float(), r0, pres, w.float(), center_shift)
    torch.testing.assert_close(out, ref, **CONV_TOL[prec])
    return ref


# The edge cases below run both kernels: fp32 (the CUDA cores; 128-row
# tiles, 16-row warp bands, 64 and 8 at Cout 128) and bf16 (the tensor
# cores; 64-row tiles, 128 at Cout 64).
PRECS = ["fp32", "bf16"]


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("center_shift", [True, False])
@pytest.mark.parametrize("cout", [32, 64, 128])
@pytest.mark.parametrize("o", [1, 63, 64, 65, 127, 128, 129])
def test_window_conv_bf16_ragged_tiles(dev, o, cout, center_shift, prec):
    """O not a multiple of the tile: the last tile's rows past O are
    neither read nor written."""
    v = o if center_shift else 97
    ref = conv_against_plain(dev, random_words(o, v, o), v, 32, cout,
                             center_shift, prec)
    assert ref.abs().max() > 0.1


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("center_shift", [True, False])
def test_window_conv_bf16_tap_in_one_row(dev, center_shift, prec):
    """A tap present in exactly one row of a tile (and no other tap in that
    tile): the tile's tap list holds it alone, and in fp32 one warp runs
    it."""
    o = v = 192
    packed = np.zeros((1, o, 9), np.int32)
    packed[0, 37, 2] = 50 | (0b010 << 24)
    packed[0, 127, 4] = 100 | (0b100 << 24)        # last row of tile 1
    packed[0, 128, 8] = (v - 1) | (0b001 << 24)    # first row of tile 2
    ref = conv_against_plain(dev, packed, v, 16, 32, center_shift, prec)
    rows = set(torch.nonzero(ref.abs().sum(-1))[:, 1].tolist())
    assert rows == {37, 127, 128}


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("cout", [32, 64, 128])
def test_window_conv_bf16_center_taps_at_tile_edges(dev, cout, prec):
    """Submanifold center column at both edges of each tile (64 or 128
    rows) and warp band: rows o-1 and o+1 belong to the neighbouring tiles
    (or lie outside [0, V))."""
    o = v = 192
    packed = np.zeros((1, o, 9), np.int32)
    for row in (0, 63, 64, 127, 128, 191):
        packed[0, row, 4] = row | (0b111 << 24)
    ref = conv_against_plain(dev, packed, v, 64, cout, True, prec)
    assert float(ref[0, [0, 63, 64, 127, 128, 191]].abs().min()) > 0


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("center_shift", [True, False])
def test_window_conv_bf16_windows_past_v(dev, center_shift, prec):
    """Present taps on the last rows, windows that clamp at V-1 and run
    past V (those rows read zero)."""
    v = 130
    r = np.random.RandomState(5)
    packed = np.zeros((1, v, 9), np.int32)
    for o in range(v - 70, v):
        for k in range(9):
            r0 = min(o + k - 4, v + 2) if k != 4 else max(o - 1, 0)
            packed[0, o, k] = max(r0, 0) | (r.randint(1, 8) << 24)
    ref = conv_against_plain(dev, packed, v, 32, 32, center_shift, prec)
    assert float(ref[0, -4:].abs().max()) > 0.1


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("cin,cout", [(4, 16), (5, 16), (12, 32), (24, 64),
                                      (128, 64), (5, 128), (64, 128),
                                      (128, 128)])
@pytest.mark.parametrize("center_shift", [True, False])
def test_window_conv_bf16_cin(dev, cin, cout, center_shift, prec):
    """Cin below the bf16 MMA depth of 16 (4: the first conv, 8-byte copies
    in bf16), odd (plain copies in bf16, 4-byte cp.async in fp32), not a
    multiple of 16, and the widest accepted, at every Cout up to 128."""
    o = 300
    v = o if center_shift else 257
    conv_against_plain(dev, random_words(o, v, cin), v, cin, cout,
                       center_shift, prec)


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("center_shift", [True, False])
def test_window_conv_bf16_wide_window(dev, center_shift, prec):
    """A 5 x 5 BEV window: 75 taps, more than one 64-bit word of tap bits
    per tile."""
    o = v = 200
    conv_against_plain(dev, random_words(o, v, 7, k=25), v, 16, 32,
                       center_shift, prec)


@pytest.mark.parametrize("prec", PRECS)
def test_window_conv_bf16_unaligned_features(dev, prec):
    """Features that start one element into an allocation (a contiguous
    view with an offset: 2 bytes in bf16, 4 in fp32) take the narrow
    copies and give the same result."""
    from chip_smoke import DTYPES
    o = v = 200
    buf = torch.randn(1 + v * 16, device=dev).to(DTYPES[prec])
    x = buf[1:].view(1, v, 16)
    assert x.data_ptr() % 16
    conv_against_plain(dev, random_words(o, v, 1), v, 16, 16, True, prec,
                       x=x)


def test_window_conv_z_conv(dev):
    """The (3, 1, 1) z conv of SpMiddleResNetFHD without its dense tail:
    one column (K=1), kz=3, 128 -> 128 channels, in both precisions."""
    for prec in PRECS:
        conv_against_plain(dev, random_words(150, 180, 3, k=1), 180, 128,
                           128, False, prec)


def test_window_conv_geometry_matches_schedule_model(dev):
    """The fp32 kernel's tile rows, warps and warp bands are those
    f32_schedule models on the CPU."""
    from det3d_tpu_torch.ops.window_conv_cuda import (F32_GEOMETRY,
                                                      kernel_geometry)
    for cout, (tile, band) in F32_GEOMETRY.items():
        tile_rows, warps, band_rows, stages, rm, rn, ks = kernel_geometry(
            cout)
        assert (tile_rows, warps, band_rows) == (tile, tile // band, band)
        # a warp's lanes cover its band and every channel, ks times over
        assert band_rows * cout * ks == 32 * rm * rn and stages >= 2
    with pytest.raises(ValueError):
        kernel_geometry(24)


def test_window_conv_fp32_unaligned_weights_raise(dev):
    """fp32 weights are staged by 16-byte cp.async: weights off a 16-byte
    boundary raise, as bf16 ones do."""
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    x = torch.zeros(1, 64, 16, device=dev)
    pk = torch.zeros(1, 64, 9, dtype=torch.int32, device=dev)
    wbuf = torch.zeros(1 + 27 * 16 * 32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        window_conv(x, pk, wbuf[1:].view(27, 16, 32), True)


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
    wbuf = torch.zeros(1 + w.numel(), device=dev).bfloat16()
    with pytest.raises(ValueError, match="16-byte"):     # unaligned weights
        window_conv(x.bfloat16(), pk, wbuf[1:].view(27, 16, 32), True)
    # a 9 x 9 window of kz 3 at Cin 128, Cout 64 needs more shared memory
    # a block than the card allows
    with pytest.raises(ValueError, match="shared memory"):
        window_conv(torch.zeros(1, 64, 128, device=dev).bfloat16(),
                    torch.zeros(1, 64, 81, dtype=torch.int32, device=dev),
                    torch.zeros(243, 128, 64, device=dev).bfloat16(), False)


# ---------------------------------------------------------------------------
# the window conv's backward (csrc/window_conv_bwd.cu, and the forward
# kernel as the subm dX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_plan(dev):
    """SECOND's host training plan (inverse rulebooks included) of two
    training scans at full scale, the second short (padded rows)."""
    from chip_smoke import POINTS, sparse_train_scene, train_config
    from chip_smoke import with_train_plan
    scene = sparse_train_scene("second", 2, train_config("second")[
        "voxel_generator"]["range"], POINTS)
    scene["num_points"][1] = 2000
    return with_train_plan("second", scene)


@pytest.mark.parametrize("name", CONV_SHAPES)
def test_backward_kernels_equal_plain(dev, train_plan, name):
    """dW (both conv kinds) and dX (the subm convs after the stem through
    the forward kernel, the strided convs over the inverse rulebook) at
    every conv of SECOND's middle against the plain twins in fp32, within
    chip_smoke.py's BWD_TOL; dW bit-equal on a second call; each wrapper
    counts one launch."""
    from chip_smoke import BWD_TOL, SECOND_SPARSE, bwd_cases
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    case = {c[0]: c for c in bwd_cases(train_plan, dev,
                                       SECOND_SPARSE)}[name]
    _, x, pk, w, subm, inv, dy = case
    r0, pres = sp.unpack_windows(pk, 3)
    dys = dy / (pk.shape[0] * pk.shape[1]) ** 0.5
    before = wc.window_conv_dw.launches
    dw = wc.window_conv_dw(x, pk, dys, subm)
    again = wc.window_conv_dw(x, pk, dys, subm)
    torch.cuda.synchronize()
    assert wc.window_conv_dw.launches == before + 2
    torch.testing.assert_close(dw, sp.window_conv_dw_ref(x, r0, pres, dys,
                                                         subm), **BWD_TOL)
    assert torch.equal(dw, again)
    if subm and x.shape[-1] >= 16:
        before = wc.window_conv_subm_dx.launches
        dx = wc.window_conv_subm_dx(dy, pk, w)
        ref = sp.window_conv_ref(dy, r0, pres,
                                 w.flip(0).transpose(1, 2), True)
        assert wc.window_conv_subm_dx.launches == before + 1
    elif not subm:
        r0i, presi, par = sp.unpack_inverse(inv, 2)
        before = wc.window_conv_inv.launches
        dx = wc.window_conv_inv(dy, inv, w, (3, 3, 3), (2, 2, 2),
                                x.shape[1])
        ref = sp.window_conv_inv_ref(dy, r0i, presi, par, w, (3, 3, 3),
                                     (2, 2, 2))
        assert wc.window_conv_inv.launches == before + 1
    else:
        return
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(dx, ref, **BWD_TOL)


@pytest.mark.parametrize("cin,cout", [(4, 16), (5, 16), (16, 128),
                                      (128, 128), (128, 64), (12, 8)])
def test_dw_kernel_widths_and_ragged_rows(dev, cin, cout):
    """dW at the widths the kernel takes (Cin 1-128, Cout a multiple of 4
    up to 128: one, two and four 4x4 blocks a thread, row slices where
    Cin*Cout is small) on random words over a row count that is no
    multiple of the 64-row tile, subm and strided."""
    from chip_smoke import BWD_TOL
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv_dw
    g = torch.Generator().manual_seed(cin * cout)
    for center_shift in (True, False):
        pk = torch.as_tensor(random_words(1000, 1000, cin)).to(dev)
        pk = pk & ((1 << 24) - 1 | (7 << 24))           # kz = 3 bits
        x = torch.randn(1, 1000, cin, generator=g).to(dev)
        dy = (torch.randn(1, 1000, cout, generator=g) / 30).to(dev)
        r0, pres = sp.unpack_windows(pk, 3)
        out = window_conv_dw(x, pk, dy, center_shift)
        torch.testing.assert_close(
            out, sp.window_conv_dw_ref(x, r0, pres, dy, center_shift),
            **BWD_TOL)


def test_inverse_kernel_on_the_z_conv(dev):
    """The strided dX of SECOND's sparse z conv ((3, 1, 1) stride (2, 1,
    1): one candidate column, two z candidates) on a device-built training
    plan without the dense tail."""
    from chip_smoke import BWD_TOL, sparse_train_scene, train_config
    from chip_smoke import with_train_plan
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv_inv
    cfg = train_config("second")
    cfg["model"]["backbone"]["dense_tail"] = False
    plan = with_train_plan("second", sparse_train_scene(
        "second", 1, cfg["voxel_generator"]["range"], 4000), cfg=cfg)
    inv = torch.as_tensor(plan["plan_inv4"], device=dev)
    o = plan["plan_down4"].shape[1]
    g = torch.Generator().manual_seed(4)
    dy = torch.randn(1, o, 64, generator=g).to(dev)
    w = torch.randn(3, 64, 64, generator=g).to(dev) / 14
    dx = window_conv_inv(dy, inv, w, (3, 1, 1), (2, 1, 1), inv.shape[1])
    r0i, presi, par = sp.unpack_inverse(inv, 2)
    ref = sp.window_conv_inv_ref(dy, r0i, presi, par, w, (3, 1, 1),
                                 (2, 1, 1))
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(dx, ref, **BWD_TOL)


def test_backward_kernels_reject_bad_inputs(dev):
    from det3d_tpu_torch.ops.window_conv_cuda import (window_conv_dw,
                                                      window_conv_inv)
    pk = torch.zeros(1, 64, 9, dtype=torch.int32, device=dev)
    x = torch.zeros(1, 64, 16, device=dev)
    with pytest.raises(ValueError, match="fp32"):
        window_conv_dw(x.bfloat16(), pk, torch.zeros(1, 64, 16, device=dev),
                       True)
    with pytest.raises(ValueError, match="multiple of 4"):
        window_conv_dw(x, pk, torch.zeros(1, 64, 18, device=dev), True)
    inv = torch.zeros(1, 64, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        window_conv_inv(torch.zeros(1, 64, 16, device=dev), inv,
                        torch.zeros(27, 6, 16, device=dev), (3, 3, 3),
                        (2, 2, 2), 64)
    with pytest.raises(ValueError, match="candidate"):
        window_conv_inv(torch.zeros(1, 64, 16, device=dev), inv,
                        torch.zeros(27, 16, 16, device=dev), (3, 3, 3),
                        (1, 1, 1), 64)


# ---------------------------------------------------------------------------
# the backward kernels at every layer shape of the training paths, and
# their schedules against the CPU models (tests/test_torch_bwd_schedule.py)
# ---------------------------------------------------------------------------

def _bwd_shapes():
    """(plan, plan key, Cin, Cout, subm) of every sparse conv the training
    paths run on their plans (the dense tails' run in chip_smoke.py's
    phase 58): SECOND's, CBGS's (Cin-5 stem) and Lyft's Cin-6 stem (on
    CBGS's plan: Lyft runs CBGS's middle), RCNN's middle, the deep grid's
    window convs and VoxelNet's (128, 16) stem (on SECOND's plan)."""
    from chip_smoke import CBGS_SPARSE, RCNN_LAYERS, SECOND_SPARSE, STEM_6
    out = []
    for plan, layers in (("second", SECOND_SPARSE), ("cbgs", CBGS_SPARSE),
                         ("cbgs", STEM_6), ("rcnn", RCNN_LAYERS),
                         ("second", (("s0", 128, 16, True),))):
        for key, cin, cout, subm in layers:
            if (plan, key, cin, cout, subm) not in out:
                out.append((plan, key, cin, cout, subm))
    return out


BWD_SHAPES = _bwd_shapes()


@pytest.fixture(scope="module")
def bwd_plans(dev, train_plan):
    """The training plans the backward cases run on: SECOND's (two scans,
    the second short), CBGS's (B=2 x 300000 points) and RCNN's (B=4 on
    SECOND's grid), built once on first use."""
    from chip_smoke import (CBGS_B, CBGS_POINTS, POINTS, RCNN_B,
                            sparse_train_scene, train_config, variant_config,
                            with_train_plan)
    made = {"second": train_plan}

    def get(name):
        if name not in made:
            if name == "cbgs":
                pc = train_config("cbgs")["voxel_generator"]["range"]
                made[name] = with_train_plan("cbgs", sparse_train_scene(
                    "cbgs", CBGS_B, pc, CBGS_POINTS))
            else:
                cfg = variant_config("rcnn", "fp32")
                made[name] = with_train_plan("second", sparse_train_scene(
                    "second", RCNN_B, cfg["voxel_generator"]["range"],
                    POINTS), cfg=cfg)
        return made[name]
    return get


def _replayed(fn):
    """fn()'s output from one replay of a CUDA graph that captured it."""
    fn()                                     # attributes set before capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _hold_bwd(fn, ref, what):
    """A backward kernel within BWD_TOL of its twin, and the same bits on a
    second call and on a CUDA-graph replay."""
    from chip_smoke import BWD_TOL
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **BWD_TOL, msg=lambda m: f"{what}: "
                               f"{m}")
    assert torch.equal(got, again), f"{what}: a second call differs"
    assert torch.equal(got, _replayed(fn)), f"{what}: a replay differs"


@pytest.mark.parametrize("plan,key,cin,cout,subm", BWD_SHAPES,
                         ids=[f"{p}-{k}-{a}x{b}" for p, k, a, b, _ in
                              BWD_SHAPES])
def test_backward_kernels_at_training_shapes(dev, bwd_plans, plan, key, cin,
                                             cout, subm):
    """dW at every conv of the training paths, and the inverse dX of each
    strided one: within BWD_TOL of the twins, bit-equal on a second call
    and on a CUDA-graph replay."""
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    data = bwd_plans(plan)
    pk = torch.as_tensor(data[f"plan_{key}"], device=dev).contiguous()
    b, o, k = pk.shape
    inv = None if subm else torch.as_tensor(data[f"plan_inv{key[4:]}"],
                                            device=dev).contiguous()
    v = o if subm else inv.shape[1]
    g = torch.Generator().manual_seed(cin * 1000 + cout)
    x = torch.randn(b, v, cin, generator=g).to(dev)
    dy = (torch.randn(b, o, cout, generator=g) / (b * o) ** 0.5).to(dev)
    r0, pres = sp.unpack_windows(pk, 3)
    _hold_bwd(lambda: wc.window_conv_dw(x, pk, dy, subm),
              sp.window_conv_dw_ref(x, r0, pres, dy, subm), "dW")
    if not subm:
        geo = ((3, 3, 3), (2, 2, 2)) if k == 9 else ((3, 1, 1), (2, 1, 1))
        w = (torch.randn(3 * k, cin, cout, generator=g) / 10).to(dev)
        dyi = dy * (b * o) ** 0.5
        r0i, presi, par = sp.unpack_inverse(inv, 2)
        ref = sp.window_conv_inv_ref(dyi, r0i, presi, par, w, *geo)
        assert float(ref.abs().max()) > 0
        _hold_bwd(lambda: wc.window_conv_inv(dyi, inv, w, *geo, v), ref,
                  "inverse dX")


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64), (64, 64)])
def test_dw_kernel_kz7_deep_windows(dev, cin, cout):
    """dW at the deep grid's window-conv widths with 7 presence bits a
    column (kz = 7, the most the kernel takes), strided and subm rulebook
    words alike (center_shift needs kz = 3): within BWD_TOL, the same bits
    twice and on a replay."""
    from det3d_tpu_torch.ops import sparse as sp
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv_dw
    r = np.random.RandomState(cin + cout)
    bits = r.randint(1, 128, size=(1, 6000, 9)) * (r.uniform(
        size=(1, 6000, 9)) < 0.5)
    pk = torch.as_tensor((r.randint(0, 7003, size=(1, 6000, 9))
                          | (bits << 24)).astype(np.int32)).to(dev)
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(1, 7000, cin, generator=g).to(dev)
    dy = (torch.randn(1, 6000, cout, generator=g) / 80).to(dev)
    r0, pres = sp.unpack_windows(pk, 7)
    _hold_bwd(lambda: window_conv_dw(x, pk, dy, False, 7),
              sp.window_conv_dw_ref(x, r0, pres, dy, False), "dW kz=7")


def test_backward_geometry_equals_the_cpu_models(dev):
    """The kernels' own geometry and grid order (window_conv_dw_geometry,
    window_conv_dw_rows, window_conv_inv_geometry) equal the CPU models
    the schedule tests hold to JAX's plans (dw_geometry, dw_grid,
    inv_geometry), at every width the wrappers take."""
    import ctypes
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    lib = wc._bwd_lib()
    names = ("tm", "tn", "team", "slices", "pairs", "lx", "ly", "xpieces",
             "split")
    for cin in range(1, 129):
        for cout in range(4, 129, 4):
            for cs_ in (True, False):
                got = (ctypes.c_int * 12)()
                assert lib.window_conv_dw_geometry(
                    2, 1000, 1000, 9, 3, cin, cout, int(cs_), 4, got) == 0
                want = wc.dw_geometry(cin, cout, cs_)
                assert list(got)[1:10] == [want[n] for n in names], (cin,
                                                                     cout)
                assert got[10] + (got[11] << 31) == want["smem"]
            if cin % 4 == 0:
                got = (ctypes.c_int * 5)()
                assert lib.window_conv_inv_geometry(cin, cout, got) == 0
                want = wc.inv_geometry(cin, cout)
                assert list(got) == [want[n] for n in ("tm", "nci", "nr",
                                                       "rb", "smem")]
    for k, kz, cs_ in ((9, 3, True), (9, 3, False), (1, 3, False),
                       (9, 7, False)):
        split = wc.DW_CENTER_SPLIT if cs_ else 1
        taps = (ctypes.c_int * (k * kz + split - 1))()
        lib.window_conv_dw_rows(k, kz, int(cs_), taps)
        assert list(taps) == [t for t, _, _ in wc.dw_grid(k * kz, k, cs_, 1)]
