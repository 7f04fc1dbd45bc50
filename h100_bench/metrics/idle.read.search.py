"""The device's idle share of the traced slice while the host was in the
stop test's read or the row gather (the program's spans), batched
search."""
from h100_bench import program_spans


def read(run):
    return program_spans.idle_share(run, program_spans.READ)
