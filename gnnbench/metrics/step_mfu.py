"""step_mfu: the training window's matrix-product operations (both nets,
forward and backward, and in contrast steps the rewire's similarity
product) over the window, in % of the card's peak for the step's dtype."""

from gnnbench.metrics import _mfu


def read(m):
    return _mfu.share(m) if m.unit == "train_nodes" else None
