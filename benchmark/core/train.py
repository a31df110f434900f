"""Training cells: train steps back to back through the program's train
step.

Set-up builds the stack (apis/train.py::build_stack), loads the seed's
weights, builds the optimizer and schedules over the mix's
``total_steps`` (apis/train.py::init_state) and the step
(parallel/train.py::make_train_step), and takes the first three steps on
the pool's first three batches through that same step object: the first
call captures its graph. What the check reads is kept from those steps:
each step's loss, the first gradient as the optimizer got it (its first
moment over (1 - b1)) leaf by leaf, and each leaf's change over the three.
The window then steps on through the pool, cycled, reading the loss on
the host every ``loss_every`` steps as a trainer's logger does, and ends
with a synchronize. Once it has closed and the program is freed, the
reference takes the same three steps from the same weights
(core/judge.py). Under ``--trace 1`` the program's tracing is on while
the step is made and its first call captures it, off for the window and
on again for the profiled stretch (core/common.py::program_trace,
traced).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.core import common, judge, traffic
from benchmark.core import trace as tr
from benchmark.core.harness import device_info
from benchmark.work import counts

CHECKED_STEPS = 3


def _tensors(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def reference_steps(R, arch, cfg, params, names, batches, total, device,
                    dtype=torch.float32):
    """The reference's readings over ``batches``: {"loss", "grad",
    "update"} as judge.train_numbers takes them, and each step's work."""
    P = {k: v.detach().clone() for k, v in params.items()}
    leaves = [P[n].requires_grad_(True) for n in names]
    adam = R.Adam(cfg, names, total)
    anchors_t = R.task_anchors(arch, device)
    losses, grad, works = [], None, []
    for i, batch in enumerate(batches):
        b = _tensors(batch, device)
        heads, rctx, _ = R.forward(arch, P, b["points"], b["num_points"],
                                   mode="train", dtype=dtype)
        tg = R.targets(arch, anchors_t, b["gt_boxes"], b["gt_classes"],
                       b["gt_valid"])
        total_loss, _ = R.loss(arch, heads, tg, anchors_t)
        grads = torch.autograd.grad(total_loss, leaves)
        _, b1 = adam.step(leaves, grads)
        losses.append(float(total_loss.detach()))
        works.append(rctx.work)
        if i == 0:
            grad = [float(m.norm()) / (1 - b1) for m in adam.mu]
        del heads, tg, total_loss, grads
    update = [float((P[n].detach() - params[n]).norm()) for n in names]
    return {"loss": losses, "grad": grad, "update": update}, works


def run(cell, args, device, t0):
    from det3d_tpu_torch.apis.train import build_stack, init_state
    from det3d_tpu_torch.parallel.train import make_train_step

    cell.seed, cell.t0 = args.seed, t0
    R = cell.reference
    mix = cell.mix
    pool = traffic.train_pool(mix, cell.cfg, args.seed)
    nb = len(pool)
    common.progress(cell, f"pool of {nb} batches")
    arch, params, ref_s = common.calibrated_params(
        cell, device, pool[0]["points"], pool[0]["num_points"])
    total = int(mix["total_steps"])
    model, vg, asg, cids, _ = build_stack(cell.cfg, device=device)
    model.load_state_dict(params)
    state, _ = init_state(cell.cfg, model, total)
    ptrace = common.program_trace(args.trace)
    step = make_train_step(state, vg, asg, cids)
    names = [n for n, _ in model.named_parameters()]
    common.progress(cell, "weights calibrated, stack built")

    specs = common.counter_specs(cell)
    before = common.read_counters(specs)
    losses = [float(step(pool[0])["loss"])]
    launches = common.launches_per_call(before, common.read_counters(specs),
                                        device)
    b1 = R.one_cycle(cell.cfg, total)(0)[1]
    grad = [float(m.norm()) / (1 - b1) for m in state.tx.mu]
    for i in range(1, CHECKED_STEPS):
        losses.append(float(step(pool[i])["loss"]))
    update = [float((p.detach() - params[n]).norm())
              for n, p in model.named_parameters()]
    prog = {"loss": losses, "grad": grad, "update": update}
    common.progress(cell, "three checked steps done")
    common.sync(device)
    if ptrace is not None:
        ptrace.enable(False)
    setup_s = time.perf_counter() - t0 - ref_s

    every = int(mix.get("loss_every", 10))
    calls = []
    k = 0
    gc.collect()
    gc.disable()                    # no collection pauses in the window
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        m = step(pool[(CHECKED_STEPS + k) % nb])
        calls.append(time.perf_counter() - a)
        k += 1
        if k % every == 0:
            float(m["loss"])
        if time.perf_counter() - start >= args.seconds:
            break
    common.sync(device)
    window_s = time.perf_counter() - start
    gc.enable()
    common.progress(cell, f"window done: {k} steps")
    info = device_info(torch, device)

    ctx = {"mode": "train", "window_s": window_s, "calls": k,
           "host_call_s": calls, "launches": launches, "traced_calls": 0,
           "peak": counts.peak_of(cell.cfg.get("precision", "fp32"))}
    breakdown = None
    traced = list(range(CHECKED_STEPS))
    if args.trace:
        def stretch():
            for i in traced:
                with tr.span("step_call"):
                    m = step(pool[i])
                with tr.span("loss_read"):
                    float(m["loss"])
        trace_info, breakdown = common.traced(cell, ctx, stretch, device,
                                              len(traced), ptrace)
        info.update(trace_info)
    del step, state, model, m
    common.free(device)

    ref, works = reference_steps(R, arch, cell.cfg, params, names,
                                 pool[:CHECKED_STEPS], total, device)
    numbers = judge.train_numbers(prog, ref, names)
    common.progress(cell, "reference done")

    if args.trace:
        work = {i: w for i, w in enumerate(works)}
        with torch.no_grad():
            for i in range(CHECKED_STEPS, nb):
                b = _tensors(pool[i], device)
                work[i] = R.forward(arch, params, b["points"],
                                    b["num_points"])[1].work
        ctx["work_calls"] = [work[(CHECKED_STEPS + i) % nb]
                             for i in range(k)]
        ctx["work_traced"] = [work[i] for i in traced]
        common.lost_records(cell, ctx)
        metrics = common.per_layer(cell, ctx)
    else:
        metrics = {"train_step_ms": {"value": window_s / k * 1e3,
                                     "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m_["name"]: metrics[m_["name"]] for m_ in cell.metrics
                   if m_["name"] in metrics}
    res = {"attempted": k, "failed": 0, "metrics": metrics, "device": info,
           "numbers": numbers}
    if breakdown is not None:
        res["breakdown"] = breakdown
    return res
