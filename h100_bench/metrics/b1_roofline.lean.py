"""B1's least time over its device time, lean fit."""
from h100_bench import readings


def read(run):
    return readings.b1_roofline(run)
