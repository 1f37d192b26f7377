"""Process start to the window's start: imports, inputs, kernel build or
load, warm-up."""


def read(m):
    return m.setup_s
