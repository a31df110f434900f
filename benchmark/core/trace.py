"""The ``--trace 1`` stretch: torch.profiler over a few calls, read as a
timeline.

The benchmark's own host spans (``record_function``: ``stage`` the batch
handed over, ``step_call`` the step's call, ``readback`` the detections
to the host, ``loss_read`` the logged loss) bracket each call. The device
events (kernels, copies, sets) are merged into busy intervals; the window
runs from the first span's start to the last span's end; the idle gaps
are the window less the busy intervals, each labelled by the host span
that covers its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

SPANS = ("stage", "step_call", "readback", "loss_read")


def span(name: str):
    """A host span of the traced stretch (one of SPANS)."""
    return torch.profiler.record_function(name)


def profile(run: Callable[[], None], device):
    """torch.profiler around ``run()``, synchronized at its end: the CPU
    and, on the card, CUDA activity."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return prof


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def timeline(prof) -> Dict:
    """{"busy_s", "window_s", "ops": {name: (seconds, records)},
    "gaps": [(label, seconds)] longest first}."""
    dev: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if e.name in SPANS:
            if not _is_device(e):
                spans.append((tr.start, tr.end, e.name))
            continue
        if _is_device(e) and tr.end > tr.start:
            dev.append((tr.start, tr.end, e.name))
    ops: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, t, n in dev:
        ops[n][0] += (t - s) * 1e-6
        ops[n][1] += 1
    if not spans or not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": dict(ops),
                "gaps": []}
    w0 = min(s for s, _, _ in spans)
    w1 = max(t for _, t, _ in spans)
    busy = []
    for s, t, _ in sorted(dev):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t)
        else:
            busy.append([s, t])
    gaps = []
    cur = w0
    for s, t in busy + [[w1, w1]]:
        if s > cur:
            mid = (cur + s) / 2
            # the innermost span covering the gap's middle
            cover = [(b - a, n) for a, b, n in spans if a <= mid <= b]
            label = min(cover)[1] if cover else "between calls"
            gaps.append((label, (s - cur) * 1e-6))
        cur = max(cur, t)
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": sum(t - s for s, t in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "gaps": gaps}


def kernel_time(tl: Dict, names, expected: int) -> Tuple[float, int, int]:
    """(device seconds of the records whose name holds any of ``names``,
    scaled up by expected / found where the profiler lost records; found;
    expected)."""
    t, found = 0.0, 0
    for op, (secs, n) in tl["ops"].items():
        if any(k in op for k in names):
            t += secs
            found += n
    if found and expected > found:
        t *= expected / found
    return t, found, expected


def breakdown(tl: Dict, top: int = 10, width: int = 160) -> Dict:
    """The ``top`` device operations by time (names cut to ``width``
    characters) and the longest idle gaps, seconds as measured."""
    ops = sorted(tl["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[k[:width], v[0]] for k, v in ops],
            "idle_gaps": [[n, s] for n, s in tl["gaps"][:top]]}


def expected_records(counters, ctx) -> int:
    """The kernel records the traced calls should hold: the launches a
    call the capture counted, times each counter's kernels a launch,
    times the calls."""
    per = sum(ctx["launches"].get(c, 0) * k for c, k in counters.items())
    return int(round(per * ctx["traced_calls"]))
