"""The window's seconds per float64 lean sweep."""
from h100_bench import readings


def read(run):
    return readings.seconds_per_sweep(run)
