"""setup_s: seconds from process start to the first timed call: the
program's set-up, the check's first steps, builds and warm-up (host clock)."""


def read(m):
    return m.setup_s
