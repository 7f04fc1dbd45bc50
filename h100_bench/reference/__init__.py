"""The benchmark's plain reference: the GPRN mean-field fit in plain
PyTorch (:mod:`h100_bench.reference.gprn`), independent of the package
under test."""
