"""Host reads per batched sweep (the program's counters), batched search."""
from h100_bench import program_spans


def read(run):
    return program_spans.syncs_per_sweep(run)
