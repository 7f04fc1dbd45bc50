"""Rows fitted to the rule (or max_iter) per second of the window."""
from h100_bench import readings


def read(run):
    return readings.fits_per_s(run)
