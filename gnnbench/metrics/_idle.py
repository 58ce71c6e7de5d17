"""The device's idle share of the traced window: one minus the union of
its operations' intervals over the window's span, in %."""


def share(m):
    if m.trace is None or m.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - m.trace["busy_s"] / m.trace["window_s"])
