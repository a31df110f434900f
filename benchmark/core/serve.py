"""Serving cells: closed-loop requests through the program's predict step.

One client hands the step a host batch of the pool (core/traffic.py), in
order and cycled, waits for the detections on the host, and sends the
next. A request's latency runs from the hand-over to the detections on
the host. Set-up builds the stack (apis/train.py::build_stack), loads the
seed's weights, makes the step (parallel/predict.py::make_predict_step)
and calls it once on every pool batch, which captures its one graph;
nothing is built or captured in the window. Under ``--trace 1`` the
program's tracing is on while the step is made and captured, so that its
graph carries the segment markers, off for the window and on again for
the profiled stretch (core/common.py::program_trace, traced).

Checked, once the window has closed and the program is freed: for each
pool batch one of its requests, drawn from the seed among its first
three (its first where the window was shorter), and a batch that has none
counts in ``unchecked`` (core/judge.py). The head's outputs of those requests are the
tensors the captured head writes, held by a forward hook set before the
capture and copied right after the request's readback.
"""

from __future__ import annotations

import sys
import gc
import time

import numpy as np
import torch

from benchmark.core import common, judge, traffic
from benchmark.core.harness import device_info
from benchmark.core import trace as tr
from benchmark.work import counts


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _clone(heads):
    return [{k: v.detach().clone() for k, v in h.items()} for h in heads]


def run(cell, args, device, t0):
    from det3d_tpu_torch.apis.train import build_stack
    from det3d_tpu_torch.parallel.predict import make_predict_step

    cell.seed, cell.t0 = args.seed, t0
    R = cell.reference
    pool = traffic.serve_pool(cell.mix, cell.cfg, args.seed)
    nb = len(pool)
    common.progress(cell, f"pool of {nb} batches")
    arch, params, ref_s = common.calibrated_params(
        cell, device, pool[0]["points"], pool[0]["num_points"])
    model, vg, asg, cids, test_cfg = build_stack(cell.cfg, device=device)
    model.load_state_dict(params)
    common.progress(cell, "weights calibrated, stack built")
    holder = {}
    hook = model.bbox_head.register_forward_hook(
        lambda m, a, o: holder.__setitem__("heads", o))
    ptrace = common.program_trace(args.trace)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    specs = common.counter_specs(cell)
    before = common.read_counters(specs)
    _host(step(pool[0]))
    launches = common.launches_per_call(before, common.read_counters(specs),
                                        device)
    for b in pool:                      # every batch once, outside the window
        _host(step(b))
    common.sync(device)
    if ptrace is not None:
        ptrace.enable(False)
    setup_s = time.perf_counter() - t0 - ref_s
    common.progress(cell, "set-up done")

    rng = np.random.default_rng(np.random.SeedSequence(args.seed))
    check = {int(bi + nb * rng.integers(0, 3)): bi for bi in range(nb)}
    kept, lat, calls = {}, [], []
    j = 0
    gc.collect()
    gc.disable()                    # no collection pauses in the window
    start = time.perf_counter()
    while True:
        batch = pool[j % nb]
        a = time.perf_counter()
        out = step(batch)
        c = time.perf_counter()
        det = _host(out)
        e = time.perf_counter()
        lat.append(e - a)
        calls.append(c - a)
        if j in check or j < nb:
            kept[j] = (j % nb, det, _clone(holder["heads"]))
        j += 1
        if e - start >= args.seconds:
            break
    window_s = e - start
    gc.enable()
    n_req = j
    common.progress(cell, f"window done: {n_req} requests")
    info = device_info(torch, device)

    ctx = {"mode": "serve", "window_s": window_s, "calls": j,
           "host_call_s": calls, "launches": launches, "traced_calls": 0,
           "peak": counts.peak_of(cell.cfg.get("precision", "fp32"))}
    breakdown = None
    if args.trace:
        def stretch():
            for i in range(nb):
                with tr.span("stage"):
                    batch = pool[i]
                with tr.span("step_call"):
                    out = step(batch)
                with tr.span("readback"):
                    _host(out)
        trace_info, breakdown = common.traced(cell, ctx, stretch, device,
                                              nb, ptrace)
        info.update(trace_info)
    hook.remove()
    del step, model, holder, out
    common.free(device)

    # the reference: every pool batch's forward, checked against its
    # request and counted
    anchors_t = R.task_anchors(arch, device)
    head_gap, mism, frag, det_gap = 0.0, 0, 0, 0.0
    work, nms = {}, {}
    # each pool batch's drawn request, or its first one where the window
    # did not reach the drawn one
    chosen = {}
    for j, entry in sorted(kept.items()):
        if j in check or entry[0] not in chosen:
            chosen[entry[0]] = entry
    del kept
    with torch.no_grad():
        for bi, det, heads in chosen.values():
            b = pool[bi]
            ref_heads, rctx, _ = R.forward(
                arch, params, torch.as_tensor(b["points"], device=device),
                torch.as_tensor(b["num_points"], device=device))
            work[bi] = rctx.work
            head_gap = max(head_gap, judge.head_gap(heads, ref_heads))
            m, f, g, nw = judge.nms_check(R, arch, heads, det, anchors_t,
                                          test_cfg)
            nms[bi] = nw
            mism += m
            frag += f
            det_gap = max(det_gap, g)
    common.progress(cell, "reference done")
    numbers = {"head_gap": head_gap, "nms_mismatch": float(mism),
               "unchecked": float(nb - len(chosen)), "det_gap": det_gap}
    print(f"checked {len(chosen)} requests of {n_req}: near-tie NMS decisions "
          f"{frag}", file=sys.stderr)

    lat_ms = np.asarray(lat) * 1e3
    scans = n_req * int(pool[0]["points"].shape[0])
    if args.trace:
        ctx["work_calls"] = [work.get(i % nb) for i in range(n_req)]
        ctx["work_traced"] = [work.get(i) for i in range(nb)]
        ctx["nms_traced"] = [nms.get(i) for i in range(nb)]
        common.lost_records(cell, ctx)
        metrics = common.per_layer(cell, ctx)
    else:
        p95 = float(np.percentile(lat_ms, 95))
        metrics = {"serve_scans_per_s": {"value": scans / window_s,
                                         "unit": "scans/s"},
                   "serve_p95_ms": {"value": p95, "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.metrics
                   if m["name"] in metrics}
    res = {"attempted": n_req, "failed": 0, "metrics": metrics, "device": info,
           "numbers": numbers}
    if breakdown is not None:
        res["breakdown"] = breakdown
    return res
