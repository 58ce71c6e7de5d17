"""span_ms.step: the mean stream ms of the program's train step span
(``ngt.ct_step`` / ``ngt.te_step``) in the traced window: the inside
counterpart of ``step_ms_p95``."""

from gnnbench.metrics import _spans


def read(m):
    return _spans.per_step(m, *_spans.STEPS)
