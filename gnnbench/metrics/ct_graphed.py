"""ct_graphed: the co-teaching steps that replayed the step's CUDA graph over
every co-teaching step of the traced window (the program's ``ct_graphed``
counter), in %: the share of steps whose kernels one launch issued."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.fill(m, "ct_graphed")
