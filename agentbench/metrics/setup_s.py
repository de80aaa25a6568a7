"""Process start to the window's start: imports, CUDA, the weights, the
engine, the kernels' libraries (built on a checkout's first run) and the
warm-up steps (s)."""


def read(record):
    return record["setup_s"]
