"""stage_copy_ms.serve: the program's host span ``step.stage_copy``
(det3d_tpu_torch/parallel/graph.py::_Graph.stage: the batch's host
arrays copied into the pinned buffers and the copies to the graph's
inputs enqueued), in host ms a served call of the ``--trace 1`` stretch
(utils/trace.py::totals())."""

from benchmark.core import trace


def read(ctx):
    return trace.span_ms(ctx, "serve", "step.stage_copy")
