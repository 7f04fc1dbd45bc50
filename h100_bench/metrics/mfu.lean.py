"""The fits' counted operations over time at the peak, lean fit."""
from h100_bench import readings


def read(run):
    return readings.mfu(run)
