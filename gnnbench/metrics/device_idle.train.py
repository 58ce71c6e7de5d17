"""device_idle.train: the device's idle share of a training cell's traced
window, in %."""

from gnnbench.metrics import _idle


def read(m):
    return _idle.share(m) if m.unit == "train_nodes" else None
