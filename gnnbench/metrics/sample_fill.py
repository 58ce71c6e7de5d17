"""sample_fill: the sampler's real child slots over the slots the static
tree allocates, over every sampled hop of the traced window (the program's
``sample_fill`` counter), in %: the share of the tree's gathers and
forward work that is not padding."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.fill(m, "sample_fill")
