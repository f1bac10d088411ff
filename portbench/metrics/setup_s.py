"""From the process's start to the window's: imports, the CUDA context, the
kernels (built on a checkout's first run, loaded after), the pool and the
warm-up solve."""


def read(run):
    return run.setup_s
