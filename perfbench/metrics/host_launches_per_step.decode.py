"""host_launches_per_step.decode: CUDA runtime kernel and graph launches a
traced decode step (a count from the profiler's host events)."""

from harness.readers import launches_per_unit


def read(run):
    return launches_per_unit(run)
