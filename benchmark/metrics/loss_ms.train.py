"""loss_ms.train: the head's losses, in device ms a train step of the
``--trace 1`` stretch: the busy time between the segment's markers (no
segment nests in it) (core/trace.py::segments), from the program's
segment ``loss`` (parallel/train.py::network_loss)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "train", "loss")
