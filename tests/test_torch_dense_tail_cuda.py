"""CBGS's dense tail on the card, on its active rows
(models/backbones.py::_RowsTail), at the cbgs-serve-points cell's shapes.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip elsewhere. Run them on the card with

    python -m pytest tests/test_torch_dense_tail_cuda.py -m cuda -q

The inputs: one batch of the ``serve-points-300k-sweeps`` mix (B=2,
240000-300000 points of 5 columns) through the benchmark's CBGS
configuration (benchmark/configs/cbgs-nusc.json), the benchmark's weights
of one seed with their BN statistics calibrated by its reference. The
middle's tail starts from the transition's rows; its masked dense twin
(tests/dense_tail_twin.py: the layers' dense forwards over the occupancy)
runs from the same rows:

- fp32 (the fp32 window-conv kernel) against the twin on the CPU, within
  FP32_TOL of the map's largest value;
- bf16 (the bf16 kernel, the bf16 epilogue) against the bf16 twin (cuDNN
  on the card), within BF16_REL in relative L2;
- in training, every tail parameter's gradient (the dW and dX kernels of
  csrc/window_conv_bwd.cu, the strided convs' dX over their inverse
  rulebooks) against the rows tail's plain twin in fp64 on the CPU,
  within GRAD_TOL of the largest (tests/test_torch_dense_tail.py holds the
  rows tail's gradients to the dense twin's on the CPU);
- the captured predict step's warm-up and capture launch the window conv
  once a conv of the middle each (11 sparse, 10 of the tail); a profiled
  replay, markers captured, runs no cuDNN convolution between the
  ``dense_tail`` markers, and runs the fp32 window-conv kernel there once
  a tail conv.
TF32 is off.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from tests.dense_tail_twin import dense_twin, rows_tail, run_rows

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
SEED = 2718281829
FP32_TOL = 1e-4
BF16_REL = 1e-2
GRAD_TOL = 1e-2
SPARSE_CONVS, TAIL_CONVS = 11, 10
# cuDNN's and cuBLAS's convolution kernels by name: implicit GEMM (xmma
# fprop, dgrad, wgrad), FFT, Winograd, direct
CUDNN_CONV = ("xmma", "implicit_gemm", "implicit_convolve", "fprop",
              "dgrad", "wgrad", "fft", "winograd", "cudnn", "conv3d",
              "convolve")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def cell_files():
    cfg = json.loads((ROOT / "benchmark/configs/cbgs-nusc.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/serve-points-300k-sweeps"
                      ".json").read_text())
    return cfg, mix


@pytest.fixture(scope="module")
def cbgs(dev):
    return cbgs_inputs(dev)


def cbgs_inputs(dev):
    """(the stack on the card, eval mode, the benchmark's calibrated
    weights; the batch; the middle's inputs: voxel features, coords)."""
    from benchmark.core import traffic, weights
    from benchmark.reference import voxelnet as R
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.parallel.predict import build_example
    cfg, mix = cell_files()
    batch = traffic.serve_pool(mix, cfg, SEED)[0]
    arch = R.Arch(cfg)
    params = weights.make_params(arch, SEED, dev)
    weights.calibrate(R, arch, params,
                      torch.as_tensor(batch["points"][:1], device=dev),
                      torch.as_tensor(batch["num_points"][:1], device=dev))
    stack = build_stack(cfg, device=dev)
    model = stack[0]
    model.load_state_dict(params)
    model.eval()
    with torch.no_grad():
        ex = build_example({k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()}, stack[1], stack[2])
        feats = model.reader(ex["voxels"], ex["num_points_per_voxel"])
    return stack, batch, feats, ex["coordinates"]


def test_tail_fp32_equals_cpu_twin(cbgs, monkeypatch):
    (model, *_), _, feats, coords = cbgs
    middle = model.backbone
    with torch.no_grad():
        out, (x, co, shape, dt) = run_rows(middle, feats, coords,
                                           model.grid_size, monkeypatch)
        assert x.dtype == out.dtype == torch.float32
        ref, _ = dense_twin(copy.deepcopy(middle).cpu(), x.cpu(), co.cpu(),
                            shape, dt)
    out = out.cpu()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    print(f"fp32 tail: max |rows - twin| {err:.3e} of {scale:.3e}")
    assert scale > 0.1
    assert err <= FP32_TOL * scale


def test_tail_bf16_equals_bf16_twin(cbgs, monkeypatch):
    """From a plan the middle serves in its ``serve_precision``, bf16."""
    from det3d_tpu_torch.models import backbones as bb
    (model, *_), _, feats, coords = cbgs
    middle = model.backbone
    spec = bb.middle_plan_spec(middle, model.grid_size, coords.shape[1],
                               host=False)
    with torch.no_grad():
        plan = bb.build_plan_device(coords, spec)
        out, (x, co, shape, dt) = run_rows(middle, feats, coords,
                                           model.grid_size, monkeypatch,
                                           plan)
        ref, _ = dense_twin(middle, x, co, shape, dt)
    assert x.dtype == out.dtype == ref.dtype == torch.bfloat16
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    print(f"bf16 tail: relative L2 {rel:.3e}")
    assert rel < BF16_REL


def bn_fp64(self, x, mask=None, dtype=None):
    """MaskedBatchNorm's forward on batch statistics, its sums in fp64."""
    xf = x.double()
    mean, var, _ = self.batch_stats(xf, mask)
    inv = torch.rsqrt(var + self.eps) * self.scale.double()
    return ((xf - mean) * inv + self.bias.double()).to(dtype or x.dtype)


def test_tail_training_gradients_near_fp64(cbgs, monkeypatch):
    """A training forward and backward of the tail on the card (fp32), each
    parameter's gradient within GRAD_TOL of the largest of the rows
    tail's plain twin in fp64 on the CPU (its BN in fp64 too). Measured on
    an H100 80GB HBM3: 1.2e-3 and 3.1e-3 for two cotangents; the dense
    twin in fp32 on the CPU reads 9.1e-3 against the same reference (BN on
    batch statistics over ~50000 rows is that ill-conditioned in fp32). A
    gradient that misses a tap or a row reads of order 1."""
    from det3d_tpu_torch.models.norm import MaskedBatchNorm
    (model, *_), _, feats, coords = cbgs
    middle = copy.deepcopy(model.backbone).train()
    exact = copy.deepcopy(middle).cpu().double()
    out, (x, co, shape, dt) = run_rows(middle, feats, coords,
                                       model.grid_size, monkeypatch)
    assert x.dtype == torch.float32
    monkeypatch.setattr(MaskedBatchNorm, "forward", bn_fp64)
    ref = rows_tail(exact, x.detach().cpu().double(), co.cpu(), shape,
                    torch.float64)
    ct = torch.randn(ref.shape, generator=torch.Generator().manual_seed(7),
                     dtype=torch.float64)
    names = [n for n, _ in middle.named_parameters()
             if n.startswith("Dense")]
    got = torch.autograd.grad((out * ct.to(out.device, out.dtype)).sum(),
                              [middle.get_parameter(n) for n in names])
    want = torch.autograd.grad((ref * ct).sum(),
                               [exact.get_parameter(n) for n in names])
    scale = max(float(w.abs().max()) for w in want)
    worst = max((float((g.cpu().double() - w).abs().max()), n)
                for n, g, w in zip(names, got, want))
    print(f"tail gradients: max |card - fp64| {worst[0]:.3e} "
          f"({worst[1]}) of {scale:.3e}")
    assert len(names) == 38              # 10 convs, 8 biased; 10 BNs
    assert worst[0] <= GRAD_TOL * scale, worst


def test_captured_step_runs_no_cudnn_conv_in_the_tail(cbgs):
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv
    from det3d_tpu_torch.parallel.predict import make_predict_step
    from det3d_tpu_torch.utils import trace
    (model, vg, asg, cids, test_cfg), batch, _, _ = cbgs
    trace.enable()
    try:
        step = make_predict_step(model, vg, asg, cids, test_cfg)
        before = window_conv.launches
        step(batch)                             # warm-up and capture
        launched = window_conv.launches - before
    finally:
        trace.enable(False)
        trace.reset()
    assert launched == 2 * (SPARSE_CONVS + TAIL_CONVS), launched
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    names = [e.name for e in sorted(
        (e for e in prof.events() if str(e.device_type).endswith("CUDA")
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start)]
    begin = names.index("mark_begin_dense_tail")
    end = names.index("mark_end_dense_tail")
    tail = names[begin + 1:end]
    convs = [n for n in tail if "window_conv" not in n
             and any(k in n.lower() for k in CUDNN_CONV)]
    assert not convs, convs
    assert sum("window_conv_f32_kernel" in n for n in tail) == TAIL_CONVS
