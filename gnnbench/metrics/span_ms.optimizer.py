"""span_ms.optimizer: the stream ms of ``ngt.optimizer`` a train step in
the traced window: both nets' Adam steps."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.optimizer")
