"""span_ms.attn: the stream ms of ``ngt.attn`` a train step in the traced
window: the tree attention of a GAT's layers (each head's scores, the
masked softmax over a parent's child slots and itself, the weighted sum),
inside ``ngt.forward``."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.attn")
