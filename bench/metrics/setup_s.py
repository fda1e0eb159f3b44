"""Process start until the window opens: the kernels' build from the
checkout's cache, the store, the weights, the warm-up."""


def read(run):
    return run["setup_s"]
