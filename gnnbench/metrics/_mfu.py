"""The share of the card's peak: the matrix-product operations the window's
calls needed (``counts.py``, from shapes) over the window's seconds, in %
of the published peak of the dtype the step computes in."""

from gnnbench import counts


def share(m):
    if not m.flops or not m.window_s:
        return None
    return 100.0 * m.flops / m.window_s / counts.PEAK_FLOPS[m.drv.peak_key()]
