"""What the serving and training runs share: the weights and the
program's stack, the launch counters, the per-layer readings."""

from __future__ import annotations

import gc
import importlib
from typing import Dict

import torch

from benchmark.core import trace as tr
from benchmark.core import weights


def progress(cell, what: str):
    """A timestamped progress line on stderr (seconds since the run's
    start)."""
    import sys
    import time
    print(f"[{time.perf_counter() - cell.t0:9.3f} s] {what}",
          file=sys.stderr, flush=True)


def load_kernels(program: str):
    """Build (on a checkout's first run) and load every CUDA library the
    program ships (``<program>/csrc/*.cu``) before the stack is built, so
    that set-up pays the build and the load once, in one place, and no
    step's first call (its warm-up and capture) builds or loads one."""
    from pathlib import Path
    csrc = importlib.import_module(f"{program}.csrc")
    for src in sorted(Path(csrc.__file__).parent.glob("*.cu")):
        csrc.load(src.stem)


def counter_specs(cell):
    """The program's launch counters the cell's per-layer readers name
    (``COUNTERS``: "module:function" strings), sorted."""
    specs = set()
    for mod in cell.readers.values():
        specs.update(getattr(mod, "COUNTERS", ()))
    return sorted(specs)


def _program_module(name: str):
    """The program's module ``name``, or None where the program has no
    such module (an older program: a metric that reads it reads None)."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        # the module or a package on its path is missing, not a module
        # that it imports
        if e.name is None or not (name + ".").startswith(e.name + "."):
            raise
        return None


def read_counters(specs) -> Dict[str, int]:
    out = {}
    for s in specs:
        mod, fn = s.split(":")
        m = _program_module(mod)
        out[s] = int(getattr(getattr(m, fn, None), "launches", 0))
    return out


def program_trace(on: bool):
    """Under ``--trace 1`` (``on``), the program's tracing
    (det3d_tpu_torch/utils/trace.py) turned on before the step is made
    and first called, so that the graph it captures carries the segment
    markers; returned, for the runner to turn off for the timed window
    and on again for the profiled stretch. None under ``--trace 0``,
    which never touches it, or where the program has no such module."""
    if not on:
        return None
    from benchmark.core.harness import PROGRAM
    mod = _program_module(f"{PROGRAM}.utils.trace")
    if mod is not None:
        mod.enable(True)
    return mod


def launches_per_call(before, after, device) -> Dict[str, float]:
    """Launches a call from the counters' move over the first call, which
    on the card runs the step twice from Python (the eager warm-up and the
    capture) and replays it once; on the CPU it runs it once."""
    n = 2 if device.type == "cuda" else 1
    return {k: (after[k] - before[k]) / n for k in after}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrated_params(cell, device, points, num_points):
    """(arch, params, reference seconds): the seed's weights with the
    reference's calibrated BN statistics, on one scan, and the seconds the
    reference's calibration took, which the runners take out of
    ``setup_s`` (the reference's time is not the program's). The peak
    memory is reset after, so that the program's run sets it."""
    import time
    arch = cell.reference.Arch(cell.cfg)
    params = weights.make_params(arch, cell.seed, device)
    sync(device)
    t = time.perf_counter()
    weights.calibrate(cell.reference, arch, params,
                      torch.as_tensor(points[:1], device=device),
                      torch.as_tensor(num_points[:1], device=device))
    free(device)
    return arch, params, time.perf_counter() - t


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def per_layer(cell, ctx) -> Dict[str, dict]:
    out = {}
    for m in cell.metrics:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def traced(cell, ctx, run, device, calls, ptrace=None):
    """Profile ``run()``, ``calls`` calls of the step, with the program's
    tracing ``ptrace`` (program_trace) on and its totals reset, and put
    into ``ctx`` the timeline, the traced calls, each segment's device ms
    a call (``segments``: core/trace.py::per_call) and the program's host
    spans (``program``: {name: (calls, host seconds)}); the device keys
    of the result line and the breakdown."""
    if ptrace is not None:
        ptrace.reset()
        ptrace.enable(True)
    try:
        prof = tr.profile(run, device)
    finally:
        if ptrace is not None:
            ptrace.enable(False)
    tl = tr.timeline(prof)
    del prof
    ctx["timeline"] = tl
    ctx["traced_calls"] = calls
    ctx["segments"] = tr.per_call(tl, calls)
    ctx["program"] = ptrace.totals() if ptrace is not None else {}
    return {"busy_s": tl["busy_s"], "window_s": tl["window_s"]}, \
        tr.breakdown(tl)


def lost_records(cell, ctx):
    """Print, for each kernel metric, the records found against those the
    capture's counters expect; and the segments' marker records against
    the markers the capture launched, each occurrence dropped for a lost
    marker, and the busy time inside and outside the segments."""
    import sys
    tl = ctx.get("timeline")
    if not tl:
        return
    for name, mod in cell.readers.items():
        kern = getattr(mod, "KERNELS", None)
        if not kern:
            continue
        exp = tr.expected_records(getattr(mod, "COUNTERS", {}), ctx)
        _, found, _ = tr.kernel_time(tl, kern, exp)
        print(f"trace {name}: {found} kernel records of {exp} expected "
              f"({max(exp - found, 0)} lost)", file=sys.stderr)
    if not any(set(tr.SEGMENT_COUNTER) <= set(getattr(m, "COUNTERS", ()))
               for m in cell.readers.values()):
        return
    exp = tr.expected_records(tr.SEGMENT_COUNTER, ctx)
    calls = max(ctx["traced_calls"], 1)
    print(f"trace segments: {tl['markers']} marker records of {exp} "
          f"expected ({max(exp - tl['markers'], 0)} lost), "
          f"{tl['marker_s'] / calls * 1e6:.3f} us of markers a call",
          file=sys.stderr)
    for k, v in sorted(tl["segments"].items()):
        if v["dropped"]:
            print(f"trace segment {k}: {v['dropped']} occurrences dropped "
                  f"(a marker lost), {v['paired']} paired", file=sys.stderr)
    own = sum(v["self_s"] for v in tl["segments"].values())
    print(f"trace segments: self {own / calls * 1e3:.4f} ms + outside "
          f"{tl['unsegmented_s'] / calls * 1e3:.4f} ms a call, busy "
          f"{tl['busy_s'] / calls * 1e3:.4f} ms a call", file=sys.stderr)
