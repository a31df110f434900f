"""stage_wait_ms.train: the program's host span ``step.stage_wait``
(det3d_tpu_torch/parallel/graph.py::_Graph.stage: the wait for the
previous step's copies out of the pinned buffers), in host ms a train
step of the ``--trace 1`` stretch (utils/trace.py::totals()). The
stretch reads each step's loss, as the window does every ``loss_every``
steps, so the host waits there for the device and this reads the
staging's own wait."""

from benchmark.core import trace


def read(ctx):
    return trace.span_ms(ctx, "train", "step.stage_wait")
