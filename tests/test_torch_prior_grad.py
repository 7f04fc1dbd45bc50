"""The gradients of the priors of gpyrn_tpu_torch against ``jax.grad`` of
gpyrn_tpu's.

HMC differentiates the log-prior (the ensemble sampler never did): the
torch autograd of each prior's ``logpdf`` must equal ``jax.grad`` of the
JAX package's inside the support, on its edges (Uniform, Jeffreys, and 0
for the priors on the half-line) and outside it, where both give 0.  A
point where JAX's gradient is not finite (Gamma at x = 0) must give the
same non-finite value.  Relative 1e-12.
"""
import jax
import numpy as np
import pytest
import torch

from gpyrn_tpu.inference import priors as jpri
from gpyrn_tpu_torch.inference import priors as tpri

torch.set_num_threads(1)

RTOL = 1e-12

PRIORS = [
    ("Normal", (0.5, 2.0), (-np.inf, np.inf)),
    ("LogNormal", (0.3, 0.7), (0.0, np.inf)),
    ("Uniform", (-1.0, 3.0), (-1.0, 3.0)),
    ("HalfNormal", (1.5,), (0.0, np.inf)),
    ("Gamma", (2.5, 0.8), (0.0, np.inf)),
    ("Gamma", (0.7, 0.8), (0.0, np.inf)),
    ("Gamma", (1.0, 0.8), (0.0, np.inf)),
    ("InvGamma", (3.0, 2.0), (0.0, np.inf)),
    ("Jeffreys", (0.5, 20.0), (0.5, 20.0)),
]


def _points(lo, hi):
    """Inside the support, on its edges, just outside them."""
    inner = [-3.0, -0.2, 0.0, 1e-3, 0.4, 1.0, 2.5, 7.0, 19.0, 60.0]
    edges = [e for e in (lo, hi) if np.isfinite(e)]
    outside = [lo - 1e-9 * max(1.0, abs(lo))] if np.isfinite(lo) else []
    outside += [hi + 1e-9 * max(1.0, abs(hi))] if np.isfinite(hi) else []
    return np.array(inner + edges + outside)


@pytest.mark.parametrize("name,args,support", PRIORS,
                         ids=[f"{p[0]}{p[1]}" for p in PRIORS])
def test_prior_grad_matches_jax(name, args, support):
    x = _points(*support)
    jgrad = jax.vmap(jax.grad(lambda v: getattr(jpri, name)(*args)
                              .logpdf(v)))
    want = np.asarray(jgrad(x))
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(
        getattr(tpri, name)(*args).logpdf(xt).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0,
                               equal_nan=True)


def test_constant_density_stays_in_the_graph():
    """Uniform's density does not depend on x inside its support; its
    gradient is 0 there (not missing), so a log-posterior of Uniform
    priors alone still differentiates."""
    x = torch.tensor([0.5, 2.0], dtype=torch.float64, requires_grad=True)
    lp = tpri.Uniform(0.0, 3.0).logpdf(x)
    assert lp.requires_grad
    (g,) = torch.autograd.grad(lp.sum(), x)
    assert torch.equal(g, torch.zeros_like(x))
