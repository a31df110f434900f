"""dense_tail_ms.serve: the sparse middle's dense tail on its active
rows (its rulebooks, its window convs, the BEV scatter), in device ms a
served call of the ``--trace 1`` stretch: the busy time between the
segment's markers (no segment nests in it) (core/trace.py::segments),
from the program's segment ``dense_tail`` (models/backbones.py, around
_RowsTail)."""

from benchmark.core import trace

COUNTERS = trace.SEGMENT_COUNTER


def read(ctx):
    return trace.segment_ms(ctx, "serve", "dense_tail")
