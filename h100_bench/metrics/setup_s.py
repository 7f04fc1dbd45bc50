"""Process start until the window opens."""
from h100_bench import readings


def read(run):
    return readings.setup_s(run)
