"""Seconds from the process's start to the window: imports, CUDA start,
the kernel and encoder builds (found in the checkout after the first run),
the inputs, the seed round and the warm-up rounds."""


def read(run):
    return run.setup_s
