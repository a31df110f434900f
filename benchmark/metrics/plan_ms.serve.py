"""plan_ms.serve: the device plan builder (the sparse stages' sites and
rulebooks), in device ms a served call of the ``--trace 1`` stretch: the
busy time between the segment's markers (no segment nests in it)
(core/trace.py::segments), from the program's segment ``plan``
(models/backbones.py::_plan_and_dtype)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "plan")
