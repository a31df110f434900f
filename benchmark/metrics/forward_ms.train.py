"""forward_ms.train: the forward pass of a train step, in device ms a
step of the ``--trace 1`` stretch: the program's segments ``reader``,
``backbone`` (with ``plan`` and ``dense_tail`` nested in it), ``neck``
and ``bbox_head`` (utils/trace.py::stage_hooks), each with everything
nested in it (core/trace.py::segments)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER
STAGES = ("reader", "backbone", "neck", "bbox_head")


def read(ctx):
    ms = [trace.segment_ms(ctx, "train", s, nested=True) for s in STAGES]
    return None if any(m is None for m in ms) else sum(ms)
