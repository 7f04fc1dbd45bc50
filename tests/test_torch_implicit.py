"""``gpyrn_tpu_torch.models.implicit`` against ``gpyrn_tpu.models.implicit``.

For (q, p) = (1, 3) at N=30 and (2, 3) at N=20 one converged state
(``fit_state`` to 1e-11, above the ~1e-12 floor the float64 state
reaches) goes through both packages' implicit value-and-gradient in
float64:

* ``elbo`` relative 1e-10, ``state_residual`` equal to 1e-12 absolute;
* ``grad`` within 1e-6 of max |g| (measured ~1e-9: the two GMRES
  orthogonalise differently and are held to their tolerance, not to each
  other's iterates), and ``adjoint_residual`` under the 1e-10 tolerance in
  both (under 1e-9 as ``tests/test_implicit.py`` asks);
* the truncated Neumann series agrees with GMRES where the sweep map
  contracts fast enough (q = 1: 1e-6 of max |g|);
* the implicit gradient agrees with the port's own unrolled gradient
  started at the fixed point (120 sweeps, q = 1: rtol 1e-5 with atol 1e-6
  of max |g|, the limits of ``tests/test_implicit.py``), and the unrolled
  one approaches it as the count grows;
* the kernel matrices' backward runs twice per call (once for ∂E/∂θ,
  once for (∂T/∂θ)ᵀw), not once per Krylov step."""
import functools

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models.implicit import implicit_value_and_grad_for as ivag_jax
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.models import gprn as tg
from gpyrn_tpu_torch.models import implicit as ti

# matrices of N <= 64 gain nothing from threads, and eight of them spinning
# beside the other test workers cost a factor of tens
torch.set_num_threads(1)

GRAD_TOL = 1e-6


def _jax_model(q, p=3):
    # q = 2 converges in ~1000 sweeps at this size and noise level, and in
    # many thousands at the q = 1 model's
    N, jitter = (30, 0.1) if q == 1 else (20, 0.3)
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 30, N))
    ys = []
    for i in range(p):
        ys += [np.sin(2 * np.pi * t / 10 + i)
               + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    m = gj.inference(q, t, *ys)
    nodes = [gj.covfunc.Periodic(1.0, 10.0, 0.5),
             gj.covfunc.Matern52(1.0, 7.0)][:q]
    weights = [gj.covfunc.SquaredExponential(1.0 + 0.2 * k, 5.0 + k)
               for k in range(q * p)]
    m.set_components(nodes, weights, [None] * p, [jitter] * p)
    return m


@functools.lru_cache(maxsize=None)
def _fixed_point(q):
    """A converged state, the JAX result on it and the port's arguments."""
    m = _jax_model(q)
    port = inference_from_jax(m, device="cpu")
    theta, data = port._theta(), port._data()
    mu0, var0 = port.engine.init_mu_var(theta, data[1])
    mu, var, _, conv = port.engine.fit_state(theta, *data, mu0, var0, 3000,
                                             1e-11)
    assert conv
    ref = ivag_jax(m.engine)(m._theta(), np.asarray(m.time, dtype=float),
                             m.y, m.yerr2, mu.numpy(), var.numpy())
    return q, ref, port.engine, (theta, *data, mu, var)


@pytest.fixture(params=[1, 2], ids=["q1p3", "q2p3"])
def fixed_point(request):
    return _fixed_point(request.param)


def _rel(g, ref):
    g, ref = np.asarray(g), np.asarray(ref)
    return np.max(np.abs(g - ref)) / np.max(np.abs(ref))


def test_implicit_matches_jax(fixed_point):
    _, ref, eng, args = fixed_point
    res = ti.make_implicit_value_and_grad(eng)(*args)
    assert isinstance(res, ti.ImplicitGrad)
    assert abs(float(res.elbo) - float(ref.elbo)) <= \
        1e-10 * abs(float(ref.elbo))
    assert res.grad.shape == (eng.spec.n_parameters,)
    assert not res.grad.requires_grad and not res.elbo.requires_grad
    assert _rel(res.grad.numpy(), ref.grad) <= GRAD_TOL
    assert abs(float(res.state_residual) - float(ref.state_residual)) <= 1e-12
    assert float(res.state_residual) < 1e-10
    assert float(res.adjoint_residual) < 1e-10          # the tolerance
    assert float(ref.adjoint_residual) < 1e-9
    # v, the Arnoldi steps with one residual per cycle, the last pull-back
    assert 3 <= res.pullbacks <= 1 + 25 * 21 + 1


def test_cached_evaluator_and_solver_names(fixed_point):
    _, _, eng, args = fixed_point
    assert ti.implicit_value_and_grad_for(eng) is \
        ti.implicit_value_and_grad_for(eng)
    with pytest.raises(ValueError, match="adjoint"):
        ti.implicit_value_and_grad_for(eng)(*args, adjoint="bogus")


def test_loose_tolerance_takes_fewer_pullbacks(fixed_point):
    _, ref, eng, args = fixed_point
    ivag = ti.implicit_value_and_grad_for(eng)
    tight = ivag(*args)
    loose = ivag(*args, tol=1e-4)
    assert loose.pullbacks < tight.pullbacks
    assert 1e-10 < float(loose.adjoint_residual) <= 1e-4
    assert _rel(loose.grad.numpy(), ref.grad) <= 1e-2
    # one cycle of three steps cannot reach 1e-10: the residual says so
    cut = ivag(*args, maxiter=1, restart=3)
    assert cut.pullbacks == 1 + (1 + 3) + 1
    assert float(cut.adjoint_residual) > 1e-10


def test_unreachable_tolerance_stops_at_the_floor(fixed_point):
    """A target under what float64 can reach: the solve ends with the
    first cycle that takes less than a tenth off the residual, and does
    not run its 25 cycles out."""
    _, ref, eng, args = fixed_point
    res = ti.implicit_value_and_grad_for(eng)(*args, tol=0.0)
    assert res.pullbacks < 12 * 21          # of 25 cycles of 21
    assert 0.0 < float(res.adjoint_residual) < 1e-10
    assert _rel(res.grad.numpy(), ref.grad) <= GRAD_TOL


def test_neumann_agrees_with_gmres():
    """q = 1 only: the q = 2 sweep map contracts too slowly for a
    truncated series."""
    _, ref, eng, args = _fixed_point(1)
    res = ti.implicit_value_and_grad_for(eng)(*args, adjoint="neumann",
                                              maxiter=400)
    assert res.pullbacks == 402
    assert _rel(res.grad.numpy(), ref.grad) <= 1e-6


def test_implicit_matches_unrolled_from_the_fixed_point():
    """q = 1 only: the q = 2 unroll needs ~1000 sweeps for 1e-6."""
    _, _, eng, args = _fixed_point(1)
    res = ti.implicit_value_and_grad_for(eng)(*args)
    gi = res.grad.numpy()
    scale = np.max(np.abs(gi))
    v_half, g_half = eng.elbo_value_and_grad(*args, 60)
    v_un, g_un = eng.elbo_value_and_grad(*args, 120)
    np.testing.assert_allclose(float(res.elbo), float(v_un), rtol=1e-10)
    err_half = np.max(np.abs(g_half.numpy() - gi)) / scale
    err_full = np.max(np.abs(g_un.numpy() - gi)) / scale
    assert err_full < max(0.3 * err_half, 1e-12)
    np.testing.assert_allclose(gi, g_un.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)


def test_kernel_matrices_backward_runs_twice_per_call(fixed_point,
                                                      monkeypatch):
    """A hook on the lattice of kernel matrices (nodes and weights, built
    in one ``kernel_matrix_rows`` call) counts the pull-backs that reach
    it: 2 per call, whatever the number of Krylov steps."""
    _, _, eng, args = fixed_point
    counts = []
    real = tg.kernel_matrix_rows

    def counted(*a, **kw):
        K = real(*a, **kw)
        if K.requires_grad:
            K.register_hook(lambda g: counts.append(1))
        return K

    monkeypatch.setattr(tg, "kernel_matrix_rows", counted)
    res = ti.make_implicit_value_and_grad(eng)(*args)
    assert res.pullbacks > 4
    assert len(counts) == 2
