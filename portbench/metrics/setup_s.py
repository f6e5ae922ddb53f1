"""setup_s (s, end to end): process start to the window's start: imports,
CUDA context, the kernel library, data, the builds and the warm-up."""


def read(run):
    return run.setup_s
