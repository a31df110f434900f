"""window_conv_roofline.serve: csrc/window_conv.cu's share of its bound
in the traced stretch: the sum of each conv's bound, the sparse
stages' and (since the dense tail runs on the window-conv kernels) the
tail's on its active sites (work/counts.py::conv_work on the reference's
rows and pairs, kinds "sparse" and "dense") over the
device time of the kernel's records, scaled by the launches the capture
counted where the profiler lost records."""

from benchmark.core import trace
from benchmark.work import counts

KERNELS = ("window_conv_f32_kernel", "window_conv_bf16_kernel")
COUNTERS = {"det3d_tpu_torch.ops.window_conv_cuda:window_conv": 1}
KINDS = ("sparse", "dense")     # the convs the kernel runs


def read(ctx):
    tl, works = ctx.get("timeline"), ctx.get("work_traced")
    if ctx["mode"] != "serve" or not tl or not works:
        return None
    secs, found, _ = trace.kernel_time(
        tl, KERNELS, trace.expected_records(COUNTERS, ctx))
    if not found:
        return None
    bound = sum(counts.bound(*counts.conv_work(w), ctx["peak"])
                for work in works for w in work if w["kind"] in KINDS)
    return 100.0 * bound / secs
