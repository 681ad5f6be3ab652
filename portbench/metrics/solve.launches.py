"""solve.launches: kernel launches per batched solve, from the profiler
(cudaLaunchKernel / cuLaunchKernel(Ex) calls) over the profiled solves."""

from portbench.readers import launches_per_step


def read(run):
    return launches_per_step(run)
