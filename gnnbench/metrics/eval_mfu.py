"""eval_mfu: the paired eval's matrix-product operations over the window,
in % of the card's peak for the eval's dtype."""

from gnnbench.metrics import _mfu


def read(m):
    return _mfu.share(m) if m.unit == "eval_nodes" else None
