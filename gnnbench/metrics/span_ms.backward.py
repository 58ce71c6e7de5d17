"""span_ms.backward: the stream ms of ``ngt.backward`` a train step in the
traced window: ``zero_grad``, ``loss.backward()``, the idle leaves' zero
gradients and, under data parallelism, the all-reduce."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.backward")
