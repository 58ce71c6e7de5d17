"""device_idle.eval: the device's idle share of an eval cell's traced
window, in %."""

from gnnbench.metrics import _idle


def read(m):
    return _idle.share(m) if m.unit == "eval_nodes" else None
