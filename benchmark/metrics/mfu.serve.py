"""mfu.serve: the step's operations at the fp32 peak over the window's
time: the reference's count of each served batch's useful products
(work/counts.py::step_flops: every conv's (output, tap) pairs that read
an active site, the RPN's and the head's convs at every position), summed
over the window's requests, over the window's seconds and the peak."""

from benchmark.work import counts


def read(ctx):
    if ctx["mode"] != "serve" or not ctx.get("work_calls") \
            or any(w is None for w in ctx["work_calls"]):
        return None
    flops = sum(counts.step_flops(w, False) for w in ctx["work_calls"])
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]
