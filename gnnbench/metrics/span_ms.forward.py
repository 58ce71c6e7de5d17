"""span_ms.forward: the stream ms of ``ngt.forward`` a train step in the
traced window: both nets' passes and the loss (in a contrast TE step also
the contrast passes)."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.forward")
