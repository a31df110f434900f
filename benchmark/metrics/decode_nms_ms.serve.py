"""decode_nms_ms.serve: the boxes' decode and the rotated NMS, in device
ms a served call of the ``--trace 1`` stretch: the busy time between the
segment's markers (no segment nests in it) (core/trace.py::segments),
from the program's segment ``decode+nms``
(parallel/predict.py::make_predict_step)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "decode_nms")
