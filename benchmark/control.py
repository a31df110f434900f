"""The readings the limits of ``correct`` are set from, on the chip.

    python benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed, at the cell's own sizes and inputs (the pool the seed
draws, the weights it makes and calibrates), the control: the reference
itself put in the program's place and computed one precision below the
configuration's (bf16 products for the fp32 configs), judged by the
numbers a run compares against the fp32 reference. Serving: the head gap
of every pool batch (its detections follow from its heads by the rules
the NMS check replays, so the head gap is the number it has to fail).
Training: the three steps' readings.
For training it also reads the fault of half the batch left out (the
mean over the rest): the reference over the first half of each batch in
the program's place. The benchmark's own runs never run this; the lower
readings come from their sound runs. Prints one JSON line a seed, with
the card's name. It runs only on the card: with no CUDA device it exits
with code 2 and prints nothing, since the CPU's bf16 arithmetic is not
the card's and its readings would set no limit.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark.core import common, harness, judge, traffic  # noqa: E402
from benchmark.core.train import CHECKED_STEPS, reference_steps  # noqa


def half(batch):
    b = batch["points"].shape[0] // 2
    return {k: v[:b] for k, v in batch.items()}


def serve_readings(cell, seed, device, dtype):
    R = cell.reference
    pool = traffic.serve_pool(cell.mix, cell.cfg, seed)
    arch, params, _ = common.calibrated_params(
        cell, device, pool[0]["points"], pool[0]["num_points"])
    gap = 0.0
    with torch.no_grad():
        for b in pool:
            pts = torch.as_tensor(b["points"], device=device)
            npts = torch.as_tensor(b["num_points"], device=device)
            ref = R.forward(arch, params, pts, npts)[0]
            ctl = R.forward(arch, params, pts, npts, dtype=dtype)[0]
            gap = max(gap, judge.head_gap(ctl, ref))
    return {"head_gap": gap}


def train_readings(cell, seed, device, dtype):
    R = cell.reference
    pool = traffic.train_pool(cell.mix, cell.cfg, seed)
    arch, params, _ = common.calibrated_params(
        cell, device, pool[0]["points"], pool[0]["num_points"])
    names = [n for n, _, kind, _ in arch.param_spec()
             if kind in ("w", "b", "scale", "shift")]
    total = int(cell.mix["total_steps"])
    batches = pool[:CHECKED_STEPS]
    ref, _ = reference_steps(R, arch, cell.cfg, params, names, batches,
                             total, device)
    ctl, _ = reference_steps(R, arch, cell.cfg, params, names, batches,
                             total, device, dtype=dtype)
    hlf, _ = reference_steps(R, arch, cell.cfg, params, names,
                             [half(b) for b in batches], total, device)
    return {"control": judge.train_numbers(ctl, ref),
            "half_batch": judge.train_numbers(hlf, ref)}


def main(argv=None, require_cuda: bool = True) -> int:
    """The readings of each seed; the exit code. ``require_cuda=False`` is
    for the tests' rehearsal on the CPU, whose lines then name the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bf16")
    args = ap.parse_args(argv)
    harness.set_environment(ROOT)
    cell = harness.Cell(ROOT, args.workload, False)
    if require_cuda:
        if not torch.cuda.is_available():
            print("control: torch.cuda.is_available() is false: the "
                  "control's readings are the card's only", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kind = torch.cuda.get_device_name(device)
    else:
        device, kind = torch.device("cpu"), "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[args.dtype]
    for seed in args.seeds:
        cell.seed = seed
        t = time.perf_counter()
        fn = serve_readings if cell.mix["mode"] == "serve" else \
            train_readings
        out = fn(cell, seed, device, dtype)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "device": kind,
                          "readings": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        common.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
