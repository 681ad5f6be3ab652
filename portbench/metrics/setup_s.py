"""setup_s: seconds from the start of the process to the first timed
step: imports, the CUDA context, nvcc where it builds, the inputs, the warm
chain and the warm-up (host clock)."""


def read(run):
    return run["setup_s"]
