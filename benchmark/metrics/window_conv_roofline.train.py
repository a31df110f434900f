"""window_conv_roofline.train: csrc/window_conv.cu's share of its bound
in the traced train steps: the forward of every conv that the kernel
runs, the sparse stages' and the dense tail's on its active sites (kinds
"sparse" and "dense"), and the mirrored forward that is a submanifold
conv's dX (all but the first layer's, whose input takes no gradient),
each bound by
work/counts.py::conv_work / bwd_work on the reference's rows and pairs,
over the device time of the kernel's records (scaled where records were
lost)."""

from benchmark.core import trace
from benchmark.work import counts

KERNELS = ("window_conv_f32_kernel", "window_conv_bf16_kernel")
COUNTERS = {"det3d_tpu_torch.ops.window_conv_cuda:window_conv": 1,
            "det3d_tpu_torch.ops.window_conv_cuda:window_conv_subm_dx": 1}
KINDS = ("sparse", "dense")     # the convs the kernel runs


def read(ctx):
    tl, works = ctx.get("timeline"), ctx.get("work_traced")
    if ctx["mode"] != "train" or not tl or not works:
        return None
    secs, found, _ = trace.kernel_time(
        tl, KERNELS, trace.expected_records(COUNTERS, ctx))
    if not found:
        return None
    bound = 0.0
    for work in works:
        for i, w in enumerate(work):
            if w["kind"] not in KINDS:
                continue
            bound += counts.bound(*counts.conv_work(w), ctx["peak"])
            if w["subm"] and i > 0:
                bound += counts.bound(*counts.bwd_work(w)["dx"],
                                      ctx["peak"])
    return 100.0 * bound / secs
