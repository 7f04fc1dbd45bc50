"""The benchmark's plain reference: the GPRN mean-field fit in plain
PyTorch (:mod:`h100_bench.reference.gprn`), independent of the package
under test, with its kernels and means one file each (``kernels/``,
``means/``, loaded by :mod:`h100_bench.reference.components`)."""
