"""host_call_ms.train: the mean host time of the step's call in the
window (the benchmark's span around each ``step(batch)``: staging the
host arrays into the captured graph's inputs and launching its replay,
with any wait the staging makes for the previous call's copies)."""

import numpy as np


def read(ctx):
    if ctx["mode"] != "train" or not ctx["host_call_s"]:
        return None
    return float(np.mean(ctx["host_call_s"])) * 1e3
