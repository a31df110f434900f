"""mfu.train: the step's operations at the fp32 peak over the window's
time: the reference's count of each batch's forward products, three
times less the first layer's dX (work/counts.py::step_flops), summed over
the window's steps, over the window's seconds and the peak."""

from benchmark.work import counts


def read(ctx):
    if ctx["mode"] != "train" or not ctx.get("work_calls"):
        return None
    flops = sum(counts.step_flops(w, True) for w in ctx["work_calls"])
    return 100.0 * flops / ctx["window_s"] / ctx["peak"]
