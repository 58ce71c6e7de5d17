"""span_ms.rewire: the stream ms of ``ngt.rewire`` a train step in the
traced window: the similarity top-k rewire of a contrast TE step (the whole
subgraph's gathers and ``topk_rewire_tree``)."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.rewire")
