"""The device's idle share of the traced slice, batched search."""
from h100_bench import readings


def read(run):
    return readings.idle(run)
