"""The package under test, as the benchmark drives it: its components
built from a configuration file, and the data and rows as tensors.

This module and ``entries/`` are the only code of the benchmark that
imports ``gpyrn_tpu_torch``; the reference and the yardstick import
nothing of it."""
from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def components(config):
    """(nodes, weights, means, jitters) of the configuration, as the
    package's kernel and mean objects; a kernel entry with ``of`` is the
    package's composite (``Sum``, ``Multiplication``) of its entries."""
    from gpyrn_tpu_torch import covfunc, meanfunc

    def kernel(c):
        cls = getattr(covfunc, c["kernel"])
        if "of" in c:
            return cls(*[kernel(e) for e in c["of"]])
        return cls(*c["pars"])

    means = [None if m is None else getattr(meanfunc, m["mean"])(*m["pars"])
             for m in config["means"]]
    return ([kernel(c) for c in config["nodes"]],
            [kernel(c) for c in config["weights"]], means,
            list(config["jitters"]))


def engine(config, N):
    """The package's shared engine of the configuration's structure."""
    from gpyrn_tpu_torch.models.gprn import make_engine, spec_from_components
    nodes, weights, means, _ = components(config)
    return make_engine(spec_from_components(nodes, weights, means, N))


def tensors(pool, dtype, device):
    """(t, y, yerr²) of a pool on the device, in ``dtype``."""
    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return put(pool.t), put(pool.y), put(pool.yerr ** 2)
