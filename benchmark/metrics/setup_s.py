"""setup_s (end to end, host clock): process start to the window's
start: imports, building the solver, kernel libraries (built only by a
checkout's first run) and one cold batch at the cell's own size."""


def read(r):
    return r.setup_s
