"""Host milliseconds per batched sweep, untraced batches."""
from h100_bench import readings


def read(run):
    return readings.sweep_ms(run)
