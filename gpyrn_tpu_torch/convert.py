"""Carry a model and its state from the JAX package into the port.

Duck-typed: it reads the JAX objects' ``.structure`` (plain tuples, the
same tags in both packages) and ``.pars`` (numpy arrays), never imports
jax, and builds the port's objects from them.
"""
from __future__ import annotations

import numpy as np
import torch

from gpyrn_tpu_torch.inference.meanfield import inference
from gpyrn_tpu_torch.ops import kernels as covfunc
from gpyrn_tpu_torch.ops import means as meanfunc

__all__ = ["components_from_jax", "inference_from_jax"]

_MEAN_CLASSES = {"Const": meanfunc.Constant, "Lin": meanfunc.Linear,
                 "Par": meanfunc.Parabola, "Cub": meanfunc.Cubic,
                 "Sin": meanfunc.Sine}


def _mean(m):
    if m is None:
        return None
    tag = m.structure[0]
    if tag in ("+", "*"):
        op = meanfunc.Sum if tag == "+" else meanfunc.Product
        return op(_mean(m.m1), _mean(m.m2))
    if tag == "MultiConst":
        return meanfunc.MultiConstant(list(np.asarray(m.pars, dtype=float)),
                                      m.obsid, m.time)
    if tag not in _MEAN_CLASSES:
        raise NotImplementedError(f"mean {tag!r} is not ported yet")
    return _MEAN_CLASSES[tag](*np.asarray(m.pars, dtype=float))


def components_from_jax(nodes, weights, means, jitters):
    """Port counterparts ``(nodes, weights, means, jitters)`` of JAX
    kernel and mean objects, with the same structures and values."""
    nodes = [covfunc.from_structure(k.structure, k.pars) for k in nodes]
    weights = [covfunc.from_structure(k.structure, k.pars) for k in weights]
    means = [_mean(m) for m in means]
    return nodes, weights, means, np.array(jitters, dtype=float)


# the settings of the mixed-precision fit that both packages share
_FIT_ATTRIBUTES = (
    "update_muvar_after", "elbo_max_iter", "refine_sweeps", "refine_tol",
    "refine_max_sweeps", "mixed_tol", "mixed_stall", "stall_block",
    "stall_tol", "stall_patience", "mixed_stop", "fit_accelerate",
    "accel_sweeps", "accel_tol", "accel_patience", "refine_method",
    "fit_method", "verbose")


def inference_from_jax(g, device) -> inference:
    """A port :class:`inference` on ``device`` holding the same data,
    components, frozen mask, cached variational state and fit settings
    (the mixed-precision fit's attributes) as the JAX inference ``g``."""
    data = []
    for y, yerr in zip(np.asarray(g.y), np.asarray(g.yerr)):
        data += [y, yerr]
    out = inference(g.q, np.asarray(g.time, dtype=float), *data,
                    device=device)
    out.set_components(*components_from_jax(g.nodes, g.weights, g.means,
                                            g.jitters))
    out._frozen_mask = np.array(g._frozen_mask, dtype=bool)
    for name in _FIT_ATTRIBUTES:
        if hasattr(g, name):
            setattr(out, name, getattr(g, name))
    if g._mu is not None:
        out._mu = torch.tensor(np.array(g._mu, dtype=float),
                               device=out.device)
        out._var = torch.tensor(np.array(g._var, dtype=float),
                                device=out.device)
    return out
