"""The fits' counted operations over time at the peak, batched search."""
from h100_bench import readings


def read(run):
    return readings.mfu(run)
