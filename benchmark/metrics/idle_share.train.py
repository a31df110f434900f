"""idle_share.train: the share of the traced stretch in which no
operation (kernel, copy or set) ran on the card, from the profiler's
timeline (core/trace.py)."""


def read(ctx):
    tl = ctx.get("timeline")
    if ctx["mode"] != "train" or not tl or tl["window_s"] <= 0 \
            or tl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
