"""window_conv_bwd_roofline.train: csrc/window_conv_bwd.cu's share of its
bound in the traced train steps: the dW of every conv the window-conv
kernels run, the sparse stages' and the dense tail's on its active sites
(kinds "sparse" and "dense"), and every strided one's inverse dX, each
bound by work/counts.py::bwd_work on the
reference's rows and pairs, over the device time of the four kernels'
records (scaled where records were lost)."""

from benchmark.core import trace
from benchmark.work import counts

KERNELS = ("window_conv_dw_kernel", "window_conv_dw_sum_kernel",
           "window_conv_inv_count_kernel", "window_conv_inv_kernel")
COUNTERS = {"det3d_tpu_torch.ops.window_conv_cuda:window_conv_dw": 2,
            "det3d_tpu_torch.ops.window_conv_cuda:window_conv_inv": 2}
KINDS = ("sparse", "dense")     # the convs the kernels run


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
        for w in work:
            if w["kind"] not in KINDS:
                continue
            bw = counts.bwd_work(w)
            bound += counts.bound(*bw["dw"], ctx["peak"])
            if not w["subm"]:
                bound += counts.bound(*bw["dx"], ctx["peak"])
    return 100.0 * bound / secs
