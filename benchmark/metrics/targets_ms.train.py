"""targets_ms.train: target assignment (the anchors' labels and
regression targets), in device ms a train step of the ``--trace 1``
stretch: the busy time between the segment's markers (no segment nests
in it) (core/trace.py::segments), from the program's segment ``targets``
(parallel/train.py::build_example)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "train", "targets")
