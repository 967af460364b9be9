"""setup_s: seconds from the process's start to the window's start
(imports, kernel load or build, weights, rendering, warm-up)."""


def read(rec):
    return rec.setup_s
