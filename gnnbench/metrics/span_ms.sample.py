"""span_ms.sample: the stream ms of ``ngt.sample`` a train step in the
traced window: the tree draw and its feature and leaf-table gathers."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.sample")
