"""The ``--trace 1`` stretch: torch.profiler over a few calls, read as a
timeline.

The benchmark's own host spans (``record_function``: ``stage`` the batch
handed over, ``step_call`` the step's call, ``readback`` the detections
to the host, ``loss_read`` the logged loss) bracket each call; the
program's host spans (``step.*``: det3d_tpu_torch/parallel/graph.py::
CapturedStep, recorded while its tracing is on) nest inside
``step_call``. The device events (kernels, copies, sets; never a host
span's annotation on the device's rows) are merged into busy intervals;
the window runs from the first benchmark span's start to the last one's
end; the idle gaps are the window less the busy intervals, each labelled
by the innermost host span, the benchmark's or the program's, that
covers its middle.

The program's segments (det3d_tpu_torch/utils/trace.py::segment) are
one-thread marker kernels on the device, ``mark_begin_<name>`` and
``mark_end_<name>``, captured into the step's graph around each layer. A
segment's occurrence runs from its begin marker's end to its end
marker's start; its time is the busy time inside that stretch (the
union of the device records there, clipped to it: idle time inside a
segment does not count), its self time that less its nested segments'.
A begin without its end, or an end without its begin (a record the
profiler lost), drops that occurrence.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

SPANS = ("stage", "step_call", "readback", "loss_read")
PROGRAM_SPANS = "step."             # the prefix of the program's host spans
BEGIN, END = "mark_begin_", "mark_end_"
# the program's marker launch counter, for a segment metric's COUNTERS:
# one marker record a launch
SEGMENT_COUNTER = {"det3d_tpu_torch.utils.trace:segment": 1}


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


def _is_span(name: str) -> bool:
    return name in SPANS or name.startswith(PROGRAM_SPANS)


def _is_marker(name: str) -> bool:
    return name.startswith(BEGIN) or name.startswith(END)


class _Busy:
    """Disjoint sorted busy intervals, and the busy time inside any
    stretch by bisection over their running sums."""

    def __init__(self, busy: List[List[float]]):
        self.starts = [s for s, _ in busy]
        self.ends = [t for _, t in busy]
        self.before = [0.0]
        for s, t in busy:
            self.before.append(self.before[-1] + t - s)

    def within(self, a: float, b: float) -> float:
        if b <= a or not self.starts:
            return 0.0
        i = bisect.bisect_right(self.ends, a)     # first ending after a
        j = bisect.bisect_left(self.starts, b)    # first starting at/after b
        if i >= j:
            return 0.0
        t = self.before[j] - self.before[i]
        t -= max(0.0, a - self.starts[i])
        t -= max(0.0, self.ends[j - 1] - b)
        return t


def segments(dev: List[Tuple[float, float, str]], busy: _Busy) -> Dict:
    """{"segments": {name: {"total", "self", "paired", "dropped"}},
    "top": busy time inside the outermost occurrences, "markers": marker
    records found, "marker": their device time}, times in the records'
    unit. Names as the markers spell them (``decode+nms`` as
    ``decode_nms``)."""
    marks = sorted((s, t, n) for s, t, n in dev if _is_marker(n))
    opened: Dict[str, float] = {}
    occ: List[Tuple[float, float, str]] = []
    dropped: Dict[str, int] = defaultdict(int)
    for s, t, n in marks:
        if n.startswith(BEGIN):
            k = n[len(BEGIN):]
            if k in opened:                 # the earlier one's end is lost
                dropped[k] += 1
            opened[k] = t
        else:
            k = n[len(END):]
            if k not in opened:             # its begin is lost
                dropped[k] += 1
                continue
            occ.append((opened.pop(k), s, k))
    for k in opened:
        dropped[k] += 1
    occ.sort(key=lambda o: (o[0], -o[1]))
    total = [busy.within(a, b) for a, b, _ in occ]
    own = list(total)
    stack: List[int] = []
    top = 0.0
    for i, (a, b, _) in enumerate(occ):
        while stack and not (occ[stack[-1]][0] <= a
                             and b <= occ[stack[-1]][1]):
            stack.pop()
        if stack:
            own[stack[-1]] -= total[i]
        else:
            top += total[i]
        stack.append(i)
    out: Dict[str, Dict] = {}
    for (_, _, k), t, o in zip(occ, total, own):
        d = out.setdefault(k, {"total": 0.0, "self": 0.0, "paired": 0,
                               "dropped": 0})
        d["total"] += t
        d["self"] += o
        d["paired"] += 1
    for k, n in dropped.items():
        out.setdefault(k, {"total": 0.0, "self": 0.0, "paired": 0,
                           "dropped": 0})["dropped"] = n
    return {"segments": out, "top": top, "markers": len(marks),
            "marker": sum(t - s for s, t, _ in marks)}


def timeline(prof) -> Dict:
    """{"busy_s", "window_s", "ops": {name: (seconds, records)},
    "gaps": [(label, seconds)] longest first, "segments": {name:
    {"total_s", "self_s", "paired", "dropped"}}, "unsegmented_s": busy
    seconds outside every segment, "markers": marker records,
    "marker_s"}."""
    dev: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    labels: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or _is_span(e.name):
            if not _is_device(e) and _is_span(e.name):
                labels.append((tr.start, tr.end, e.name))
                if e.name in SPANS:
                    spans.append((tr.start, tr.end, e.name))
            continue
        if _is_device(e) and (tr.end > tr.start or _is_marker(e.name)):
            dev.append((tr.start, tr.end, e.name))
    ops: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, t, n in dev:
        ops[n][0] += (t - s) * 1e-6
        ops[n][1] += 1
    if not spans or not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": dict(ops),
                "gaps": [], "segments": {}, "unsegmented_s": 0.0,
                "markers": 0, "marker_s": 0.0}
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
            cover = [(b - a, n) for a, b, n in labels if a <= mid <= b]
            label = min(cover)[1] if cover else "between calls"
            gaps.append((label, (s - cur) * 1e-6))
        cur = max(cur, t)
    gaps.sort(key=lambda g: -g[1])
    busy_s = sum(t - s for s, t in busy) * 1e-6
    seg = segments(dev, _Busy(busy))
    return {"busy_s": busy_s,
            "window_s": (w1 - w0) * 1e-6,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "gaps": gaps,
            "segments": {k: {"total_s": v["total"] * 1e-6,
                             "self_s": v["self"] * 1e-6,
                             "paired": v["paired"], "dropped": v["dropped"]}
                         for k, v in seg["segments"].items()},
            "unsegmented_s": busy_s - seg["top"] * 1e-6,
            "markers": seg["markers"], "marker_s": seg["marker"] * 1e-6}


def per_call(tl: Dict, calls: int) -> Dict[str, Dict]:
    """Each segment's device ms a traced call, {"self_ms", "total_ms",
    "paired", "dropped"}: its seconds over the occurrences paired, times
    the occurrences seen (paired and dropped) a call."""
    out = {}
    for k, v in tl.get("segments", {}).items():
        if not v["paired"] or calls <= 0:
            continue
        scale = (v["paired"] + v["dropped"]) / v["paired"] / calls * 1e3
        out[k] = {"self_ms": v["self_s"] * scale,
                  "total_ms": v["total_s"] * scale,
                  "paired": v["paired"], "dropped": v["dropped"]}
    return out


def segment_ms(ctx, mode: str, name: str, nested: bool = False):
    """A segment's device ms a traced call (its self time, or with
    ``nested`` its time with its nested segments'), or None where the run
    is of another mode or the trace holds no occurrence of it."""
    seg = ctx.get("segments", {}).get(name)
    if ctx["mode"] != mode or seg is None:
        return None
    return seg["total_ms" if nested else "self_ms"]


def span_ms(ctx, mode: str, name: str):
    """The program's host span ``name``: its host ms a call over the
    traced stretch (utils/trace.py::totals()), or None where the run is
    of another mode or the program recorded no such span."""
    calls, secs = ctx.get("program", {}).get(name, (0, 0.0))
    if ctx["mode"] != mode or not calls:
        return None
    return secs / calls * 1e3


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
