"""The program's span table (``noise_gnn_tpu_torch.utils.profiling``) as the
traced window filled it: the only time a profiler runs in a benchmark
process. A span's stream time is read per train step, the calls of
``ngt.ct_step`` and ``ngt.te_step`` (a ``te_warm`` call is a whole epoch of
them). A program without the table, or a span that saw no calls, gives
nothing."""

STEPS = ("ngt.ct_step", "ngt.te_step")


def _profiling():
    from noise_gnn_tpu_torch.utils import profiling

    return profiling


def per_step(m, *names):
    """Total stream ms of the spans ``names`` over the window's train steps."""
    read = getattr(_profiling(), "spans", None)
    if m.trace is None or read is None:
        return None
    tab = read()
    steps = sum(tab[s]["calls"] for s in STEPS if s in tab)
    rows = [tab[k] for k in names if tab.get(k, {}).get("calls")]
    if not steps or not rows:
        return None
    return sum(r["ms"] for r in rows) / steps


def fill(m, name):
    """Counter ``name``'s hits over its slots in the window, in %."""
    read = getattr(_profiling(), "counts", None)
    if m.trace is None or read is None:
        return None
    c = read().get(name)
    if not c or not c["slots"]:
        return None
    return 100.0 * c["hits"] / c["slots"]
