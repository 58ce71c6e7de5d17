"""rewire_sim_ms: the stream ms of ``ngt.rewire_sim`` a train step in the
traced window: the segment extrema of the rewire's similarity blocks (the
program's extrema kernel), inside ``ngt.rewire``."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, "ngt.rewire_sim")
