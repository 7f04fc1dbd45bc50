"""The vendor linear algebra's share of the device time, lean fit."""
from h100_bench import readings


def read(run):
    return readings.linalg_share(run)
