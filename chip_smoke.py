"""Smoke run of the PyTorch / CUDA port (det3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the flagship PointPillars serving step at
KITTI-car scale, through the entry points a user calls, and prints one line
per phase:

  1. device: the card, as nvidia-smi names it, and its power limit;
  2. build: nvcc builds csrc/rotated_nms.cu (sm_90a) from the checkout;
  3. kernel against plain: the rotated-NMS keep masks of the CUDA kernel
     and of its plain PyTorch twin, on the card, must be equal at the
     flagship shape (N=8 samples, K=1000 boxes), at K=333, all invalid,
     duplicated boxes and zero-size boxes;
  4. flagship predict: build_stack from the flagship config (full widths,
     fp32, 12000 pillars of 32 points), random weights from
     torch.Generator().manual_seed(0), B=8 structured scans of 16384
     points; detections must be finite, (8, 100, 7), at least one valid,
     and the NMS kernel must have been launched;
  5. the same weights on the CPU at B=1: head outputs agree with the card's
     within the stated tolerance, and the CPU post-processing (plain NMS)
     fed the card's head outputs gives exactly the card's detections;
  6. timing with CUDA events (5 warm-up runs, median of 20): predict ms per
     scan at B=8, its stages, and the NMS kernel against its plain twin.

TF32 is off throughout (cuDNN and matmul), so the card computes in full
fp32 like the CPU. Any failed check raises and the script exits non-zero;
without a CUDA device it exits 1 before printing anything. The last two
lines are a JSON object of the kernels and the JSON result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, POINTS, SEED = 8, 16384, 3
IOU_THR = 0.5
IOU_MARGIN = 1e-4
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)   # card vs CPU fp32: sum order only
DET_TOL = 1e-5                          # CPU vs card decode: last-bit exp/sin
WARMUP, REPEAT = 5, 20


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# NMS cases (also used by tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

def clustered_boxes(n, k, seed, n_objects=60):
    """(n, k, 5) car-sized BEV boxes [x, y, w, l, r] clustered around
    n_objects objects per sample, as a detector's candidates are."""
    r = np.random.RandomState(seed)
    out = np.empty((n, k, 5), np.float32)
    for s in range(n):
        obj = r.randint(0, n_objects, k)
        ctr = r.uniform([0, -40], [70, 40], (n_objects, 2))
        yaw = r.uniform(-np.pi, np.pi, n_objects)
        out[s, :, :2] = ctr[obj] + r.normal(0, 0.6, (k, 2))
        out[s, :, 2] = r.uniform(1.4, 1.9, k)
        out[s, :, 3] = r.uniform(3.4, 4.4, k)
        out[s, :, 4] = yaw[obj] + r.normal(0, 0.3, k)
    return out


def nms_inputs(boxes, valid, device):
    """(N, K, 5) boxes -> the kernel's (corners, area, valid) on device."""
    from det3d_tpu_torch.core.geometry import _ccw, box_to_corners, \
        polygon_area
    b = torch.as_tensor(boxes, device=device)
    corners = _ccw(box_to_corners(b))
    n, k = b.shape[:2]
    return (corners.reshape(n, k, 8).contiguous(),
            polygon_area(corners).contiguous(),
            torch.as_tensor(valid, device=device).contiguous())


def clear_of_threshold(corners, area, valid):
    """Invalidate the later box of each valid pair whose plain IoU lies
    within IOU_MARGIN of the threshold; returns the new valid mask."""
    from det3d_tpu_torch.ops.nms_cuda import pairwise_iou_from_corners
    iou = pairwise_iou_from_corners(corners, area)
    close = (iou - IOU_THR).abs() < IOU_MARGIN
    close = torch.triu(close, diagonal=1) & valid[:, :, None] \
        & valid[:, None, :]
    valid = valid & ~close.any(dim=1)
    live = torch.triu(valid[:, :, None] & valid[:, None, :], diagonal=1)
    assert bool(((iou - IOU_THR).abs()[live] >= IOU_MARGIN).all())
    return valid


def nms_cases(device):
    """name -> (corners, area, valid) on device, every valid pair's IoU at
    least IOU_MARGIN from the threshold where it decides anything."""
    cases = {}
    for name, (n, k, seed) in {"flagship N=8 K=1000": (8, 1000, 0),
                               "K=333": (3, 333, 1)}.items():
        boxes = clustered_boxes(n, k, seed)
        valid = np.random.RandomState(seed).uniform(size=(n, k)) > 0.05
        c, a, v = nms_inputs(boxes, valid, device)
        cases[name] = (c, a, clear_of_threshold(c, a, v))
    boxes = clustered_boxes(2, 1000, 2)
    cases["all invalid"] = nms_inputs(boxes, np.zeros((2, 1000), bool),
                                      device)
    dup = np.repeat(clustered_boxes(1, 100, 3), 10, axis=1)   # 100 x 10
    dup[0, :, :2] += np.repeat(np.arange(100)[:, None] * 100.0, 10, 0)
    cases["duplicates"] = nms_inputs(dup, np.ones((1, 1000), bool), device)
    zero = clustered_boxes(2, 500, 4)
    zero[:, ::4, 2:4] = 0.0                       # points among the boxes
    c, a, v = nms_inputs(zero, np.ones((2, 500), bool), device)
    cases["zero-size"] = (c, a, v)
    return cases


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, warmup=WARMUP, repeat=REPEAT):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def interleaved_ms(fns, rounds=REPEAT):
    """Median ms of each fn, timed in turns (a, b, b, a, ...) so that both
    see the same clocks."""
    for fn in fns.values():
        for _ in range(WARMUP):
            fn()
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(cuda_ms(fns[n], warmup=0, repeat=1))
    return {n: statistics.median(t) for n, t in times.items()}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        sys.exit(1)
    import det3d_tpu_torch  # noqa: F401  (fails here, before any output,
    #                         when the script runs outside the checkout)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("phase 1 device (nvidia-smi name, power.limit):")
    log(smi)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}; TF32 off")
    return smi


def phase_build():
    from det3d_tpu_torch import csrc
    t0 = time.perf_counter()
    path = csrc.build("rotated_nms")
    csrc.load("rotated_nms")
    log(f"phase 2 build: {path.name} in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")


def phase_kernel(dev):
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    worst = 0
    for name, (c, a, v) in nms_cases(dev).items():
        keep = rotated_nms_keep(c, a, v, IOU_THR)
        ref = rotated_nms_keep_ref(c, a, v, IOU_THR)
        torch.cuda.synchronize()
        diff = int((keep != ref).sum())
        worst = max(worst, int((keep.int() - ref.int()).abs().max()))
        log(f"phase 3 kernel vs plain [{name}] N={c.shape[0]} "
            f"K={c.shape[1]}: kept {int(keep.sum())} of {int(v.sum())} "
            f"valid, mismatches {diff}")
        if diff:
            raise AssertionError(f"keep masks differ on {name}")
        if name == "all invalid" and keep.any():
            raise AssertionError("all-invalid input kept a box")
        if name == "duplicates" and int(keep.sum()) != 100:
            raise AssertionError("duplicates: expected one box per group")
    return worst


def flagship_stack(device, state=None):
    from det3d_tpu_torch.apis.flagship import flagship_config
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.models.builder import init_weights
    model, vg, asg, cids, test_cfg = build_stack(flagship_config())
    if state is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state)
    return model.to(device), vg, asg, cids, test_cfg


def out_pillars(vg, batch, dev):
    pts = torch.as_tensor(batch["points"], device=dev)
    n = torch.as_tensor(batch["num_points"], device=dev)
    return vg.generate_batch(pts, n)["num_voxels"].tolist()


def phase_predict(dev, batch):
    from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
    from det3d_tpu_torch.parallel.predict import make_predict_step
    model, vg, asg, cids, test_cfg = flagship_stack("cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(dev)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    rotated_nms_keep.launches = 0
    out = step(batch)
    torch.cuda.synchronize()
    launches = rotated_nms_keep.launches
    shape = tuple(out["box3d_lidar"].shape)
    n_valid = out["valid"].sum(dim=1).tolist()
    log(f"phase 4 flagship predict B={B} P={POINTS}: boxes {shape}, valid "
        f"per scan {n_valid}, NMS kernel launches {launches}, pillars per "
        f"scan {out_pillars(vg, batch, dev)}")
    if shape != (B, 100, 7):
        raise AssertionError(f"box3d_lidar shape {shape}")
    for k in ("box3d_lidar", "scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} not finite")
    if sum(n_valid) < 1:
        raise AssertionError("no valid detection")
    if launches < 1:
        raise AssertionError("the NMS kernel was not launched")
    return (model, vg, asg, test_cfg, step), state, launches


def phase_cpu(dev, model, state, batch):
    from det3d_tpu_torch.parallel.predict import build_example
    cpu_model, vg, asg, cids, test_cfg = flagship_stack("cpu", state)
    one = {k: v[:1] for k, v in batch.items()}
    with torch.no_grad():
        ex_d = build_example({k: torch.as_tensor(v, device=dev)
                              for k, v in one.items()}, vg, asg)
        ex_c = build_example({k: torch.as_tensor(v) for k, v in one.items()},
                             vg, asg)
        for k in ("voxels", "coordinates", "num_points_per_voxel"):
            if not torch.equal(ex_d[k].cpu(), ex_c[k]):
                raise AssertionError(f"voxelizer {k} differs card vs CPU")
        heads_d = model(ex_d["voxels"], ex_d["num_points_per_voxel"],
                        ex_d["coordinates"])
        heads_c = cpu_model(ex_c["voxels"], ex_c["num_points_per_voxel"],
                            ex_c["coordinates"])
        worst = 0.0
        for k in heads_c[0]:
            d, c = heads_d[0][k].cpu(), heads_c[0][k]
            err = float((d - c).abs().max())
            worst = max(worst, err)
            if not torch.allclose(d, c, **HEAD_TOL):
                raise AssertionError(f"head {k}: card vs CPU max err {err}")
        log(f"phase 5 card vs CPU B=1: voxelizer equal; head outputs max "
            f"abs err {worst:.3e} (tolerance rtol={HEAD_TOL['rtol']} "
            f"atol={HEAD_TOL['atol']})")
        det_d = model.predict(ex_d, heads_d, test_cfg)
        det_c = cpu_model.predict(
            ex_c, [{k: v.cpu() for k, v in h.items()} for h in heads_d],
            test_cfg)
    for k in ("valid", "label_preds"):
        if not torch.equal(det_d[k].cpu(), det_c[k]):
            raise AssertionError(f"post-processing {k} differs")
    errs = {k: float((det_d[k].cpu() - det_c[k]).abs().max())
            for k in ("box3d_lidar", "scores")}
    if max(errs.values()) > DET_TOL:
        raise AssertionError(f"post-processing differs: {errs}")
    log(f"phase 5 CPU post-processing of the card's heads: valid mask and "
        f"labels equal ({int(det_c['valid'].sum())} valid), boxes max err "
        f"{errs['box3d_lidar']:.2e}, scores max err {errs['scores']:.2e} "
        f"(tolerance {DET_TOL})")


def phase_timing(dev, stack, batch, smi):
    from det3d_tpu_torch.ops.nms_cuda import (rotated_nms_keep,
                                              rotated_nms_keep_ref)
    from det3d_tpu_torch.parallel.predict import build_example
    model, vg, asg, test_cfg, step = stack
    batch_d = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    predict_ms = cuda_ms(lambda: step(batch_d))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"phase 6 predict B={B}: {predict_ms:.3f} ms/batch, "
        f"{predict_ms / B:.3f} ms/scan, {B * 1e3 / predict_ms:.1f} scans/s, "
        f"peak memory {peak:.0f} MiB [{smi}]")

    with torch.no_grad():
        ex = build_example(batch_d, vg, asg)
        heads = model(ex["voxels"], ex["num_points_per_voxel"],
                      ex["coordinates"])
        stages = {
            "voxelize": lambda: build_example(batch_d, vg, asg),
            "network": lambda: model(ex["voxels"], ex["num_points_per_voxel"],
                                     ex["coordinates"]),
            "decode+nms": lambda: model.predict(ex, heads, test_cfg),
        }
        parts = {k: cuda_ms(fn) for k, fn in stages.items()}
    log(f"phase 6 stages B={B} (ms/batch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))

    c, a, v = nms_cases(dev)["flagship N=8 K=1000"]
    nms_ms = interleaved_ms({
        "plain": lambda: rotated_nms_keep_ref(c, a, v, IOU_THR),
        "kernel": lambda: rotated_nms_keep(c, a, v, IOU_THR)})
    log(f"phase 6 rotated NMS keep N=8 K=1000: kernel "
        f"{nms_ms['kernel']:.4f} ms, plain {nms_ms['plain']:.4f} ms "
        f"[{smi}]")

    torch.backends.cudnn.allow_tf32 = True
    tf32_ms = cuda_ms(lambda: step(batch_d))
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 6 predict B={B} with cuDNN TF32 on (PyTorch's default): "
        f"{tf32_ms:.3f} ms/batch, {tf32_ms / B:.3f} ms/scan")
    return nms_ms


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel_err = phase_kernel(dev)

    from det3d_tpu_torch.utils.synth import structured_batch
    from det3d_tpu_torch.apis.flagship import PC_RANGE
    batch = structured_batch(B, POINTS, PC_RANGE, seed=SEED)
    stack, state, launches = phase_predict(dev, batch)
    phase_cpu(dev, stack[0], state, batch)
    times = phase_timing(dev, stack, batch, smi)

    print(json.dumps({"kernels": [{
        "name": "rotated_nms_keep", "route": "cuda",
        "source": "det3d_tpu_torch/csrc/rotated_nms.cu",
        "replaces": "det3d_tpu/ops/nms_pallas.py:38",
        "launches": launches, "max_abs_err": float(kernel_err),
        "ms": times["kernel"], "plain_ms": times["plain"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
