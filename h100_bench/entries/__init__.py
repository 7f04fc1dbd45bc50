"""The entries a window drives, one module each, found by the name in a
traffic mix's ``entry``.  Each defines ``Entry(config, traffic, pool,
device, dtype)`` with ``warm_up()`` and ``fit(theta) -> Fits``."""
