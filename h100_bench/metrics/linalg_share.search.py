"""The vendor linear algebra's share of the device time, batched search."""
from h100_bench import readings


def read(run):
    return readings.linalg_share(run)
