"""nms_roofline.serve: csrc/rotated_nms.cu's share of its bound in the
traced stretch: each request's NMS launch bound by work/counts.py::
nms_work summed over its sample-task problems (the valid candidates and
the pairs whose circumcircles meet, counted by the reference over the
request's candidates), over the device time of the mask and scan
kernels' records (scaled where records were lost)."""

from benchmark.core import trace
from benchmark.work import counts

KERNELS = ("nms_mask_kernel", "nms_scan_kernel")
COUNTERS = {"det3d_tpu_torch.ops.nms_cuda:rotated_nms_keep": 2}


def read(ctx):
    tl, nms = ctx.get("timeline"), ctx.get("nms_traced")
    if ctx["mode"] != "serve" or not tl or not nms \
            or any(n is None for n in nms):
        return None
    secs, found, _ = trace.kernel_time(
        tl, KERNELS, trace.expected_records(COUNTERS, ctx))
    if not found:
        return None
    bound = 0.0
    for call in nms:
        nbytes = flops = 0.0
        for valid, near, slots in call:
            b, f = counts.nms_work(valid, near, slots)
            nbytes, flops = nbytes + b, flops + f
        bound += counts.bound(nbytes, flops, counts.FP32_FLOPS)
    return 100.0 * bound / secs
