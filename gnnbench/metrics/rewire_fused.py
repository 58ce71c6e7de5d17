"""rewire_fused: the row blocks whose segment extrema came from the
program's extrema kernel (its fused route) over every row block the rewire
swept in the traced window (the program's ``rewire_fused`` counter), in %."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.fill(m, "rewire_fused")
