"""The gradient path of gpyrn_tpu_torch against gpyrn_tpu, on the CPU.

The same inputs, made with numpy from a seed, go through both packages in
float64 (float32 where stated), with these tolerances:

* ``linalg.kernel_matrix`` differentiated by autograd (on the CPU the
  wrapper takes the plain version) against ``jax.vjp`` of the JAX
  package's ``kernel_matrix``, contracted with a random adjoint G: all 18
  leaves the CUDA kernel takes plus two composites at N=33, rtol 1e-11
  (atol 1e-11 of max |g|); float32 rtol 1e-4 of max |g|;
* autograd through ``blocked_chol_diag_ainv`` at N=300 with block 128
  (three strips and a padded tail) against ``jax.grad`` of the JAX
  blocked factorization: 1e-9 of max |g|;
* ``Engine.elbo_fixed`` / ``elbo_value_and_grad`` against the JAX engine
  for (q, p) ∈ {(1, 3), (2, 3)} at N=48 and n_sweeps ∈ {1, 3}: value
  relative 1e-9, gradient 1e-8 of max |g| (both differentiate the same
  operations; the libraries round differently);
* ``elbo_refine`` equals repeated ``sweep_once`` exactly (same operations);
* the float32 gradient: see its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LEAF_CASES
import gpyrn_tpu as gj
from gpyrn_tpu.models import gprn as jg
from gpyrn_tpu.ops import blocked as jb
from gpyrn_tpu.ops import linalg as jlin
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.models import gprn as tg
from gpyrn_tpu_torch.ops import blocked as tb
from gpyrn_tpu_torch.ops import cuda_kernels as ck
from gpyrn_tpu_torch.ops import linalg as tlin

KM_CASES = LEAF_CASES + [
    (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)),
    (("*", ("QP",), ("+", ("C",), ("PW",))),
     (1.1, 20.0, 13.0, 0.6, 0.8, 30.0)),
]


def _km_inputs(N, dtype):
    rng = np.random.default_rng(N)
    t = np.sort(rng.uniform(0, 100, N)).astype(dtype)
    t[5] = t[4]                     # r = 0 off the diagonal too
    G = rng.standard_normal((N, N)).astype(dtype)
    return t, G


def _km_grads(structure, pars, dtype, N=33):
    t, G = _km_inputs(N, dtype)
    pars = np.asarray(pars, dtype=dtype)
    _, vjp = jax.vjp(lambda p: jlin.kernel_matrix(structure, p,
                                                  jnp.asarray(t)),
                     jnp.asarray(pars))
    g_jax = np.asarray(vjp(jnp.asarray(G))[0])
    p = torch.tensor(pars, requires_grad=True)
    K = tlin.kernel_matrix(structure, p, torch.tensor(t))
    (g_port,) = torch.autograd.grad(K, p, grad_outputs=torch.tensor(G))
    return g_port.numpy(), g_jax


@pytest.mark.parametrize("structure,pars", KM_CASES,
                         ids=[str(c[0]) for c in KM_CASES])
def test_kernel_matrix_grad_matches_jax(structure, pars):
    before = dict(ck.LAUNCHES)
    g_port, g_jax = _km_grads(structure, pars, np.float64)
    assert ck.LAUNCHES == before        # the CPU takes the plain version
    np.testing.assert_allclose(g_port, g_jax, rtol=1e-11,
                               atol=1e-11 * np.max(np.abs(g_jax)))


def test_kernel_matrix_grad_matches_jax_f32():
    """float32: the jitter's scaled term wins (4·eps·N·k(0) > 1e-6), so
    its gradient flows back into k(0)."""
    g_port, g_jax = _km_grads(("QP",), dict(LEAF_CASES)[("QP",)], np.float32,
                              N=200)
    assert g_port.dtype == np.float32
    np.testing.assert_allclose(g_port, g_jax, rtol=0,
                               atol=1e-4 * np.max(np.abs(g_jax)))


def test_kernel_matrix_grad_ref_is_the_contraction():
    """The plain version of B1′ is autograd of the kernel matrix without
    its jitter: equal to Σ G ∂K/∂θ from the Jacobian."""
    t, G = _km_inputs(20, np.float64)
    structure, pars = ("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)
    tt, p = torch.tensor(t), torch.tensor(pars, dtype=torch.float64)
    J = torch.autograd.functional.jacobian(
        lambda q: tlin.kernel_matrix(structure, q, tt), p)
    g = ck.kernel_matrix_grad_ref(structure, p, tt, torch.tensor(G))
    torch.testing.assert_close(g, torch.einsum("ij,ijm->m",
                                               torch.tensor(G), J),
                               rtol=1e-12, atol=0)


def test_blocked_factorization_grad_multi_strip():
    """N=300, block 128: three strips and a padded tail, the case that
    in-place strip updates broke."""
    rng = np.random.default_rng(3)
    N, B = 300, 2
    t = np.sort(rng.uniform(0, 30, N))
    r = t[:, None] - t[None, :]
    A = np.stack([(1 + b) * np.exp(-0.5 * r ** 2 / (2 + b) ** 2)
                  + np.diag(rng.uniform(0.05, 0.5, N)) for b in range(B)])
    WL = np.tril(rng.standard_normal((B, N, N)))
    wd = rng.standard_normal((B, N))

    def loss_jax(A):
        L, d = jb.blocked_chol_diag_ainv(A, block=128)
        return jnp.sum(L * WL) + jnp.sum(d * wd)

    g_jax = np.asarray(jax.grad(loss_jax)(jnp.asarray(A)))
    At = torch.tensor(A, requires_grad=True)
    L, d = tb.blocked_chol_diag_ainv(At, block=128)
    (torch.sum(L * torch.tensor(WL)) + torch.sum(d * torch.tensor(wd))
     ).backward()
    g_port = At.grad.numpy()
    assert np.max(np.abs(g_port - g_jax)) <= 1e-9 * np.max(np.abs(g_jax))


def test_clamp_ties_split_the_gradient_as_jax():
    """The clamp of diag Σ at its ties (Kdiag == d_add, the value on the
    envelope, the value on the floor) passes the same gradients as the JAX
    package's ``jnp.clip(d_sig, tiny, jnp.minimum(Kdiag, d_add))``
    (``gpyrn_tpu/models/gprn.py:456-465``)."""
    tiny = np.finfo(np.float64).tiny
    d_add = np.array([0.5, 0.25, 2.0, tiny])   # the last sits on the floor
    dAinv = np.array([0.0, 1.0, 0.1, 0.0])
    Kdiag = np.array([0.5, 0.3, 1.0, 1.0])

    def jax_diag_sigma(d, a, k):
        d_sig = d - d * d * a
        return jnp.sum(jnp.clip(d_sig, jnp.finfo(d_sig.dtype).tiny,
                                jnp.minimum(k, d)))

    ref = jax.grad(jax_diag_sigma, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (d_add, dAinv, Kdiag)))
    args = [torch.tensor(a, requires_grad=True) for a in (d_add, dAinv, Kdiag)]
    tg.Engine._diag_sigma(*args).sum().backward()
    for a, r in zip(args, ref):
        np.testing.assert_array_equal(a.grad.numpy(), np.asarray(r))

    # kernel_diag's jitter max(nugget, 4·eps·Σd) at its tie: a nugget
    # equal to the scaled term splits the gradient as jnp.maximum does
    # (``gpyrn_tpu/ops/linalg.py:159-160``)
    t = np.linspace(0.0, 3.0, 4)
    pars = np.array([1.5, 2.0])
    tie = float(4.0 * np.finfo(np.float64).eps * 4 * pars[0] ** 2)
    for nugget in (tie, 0.5 * tie, 2.0 * tie):
        g_jax = jax.grad(lambda p: jnp.sum(jlin.kernel_diag(
            ("SE",), p, jnp.asarray(t), nugget)))(jnp.asarray(pars))
        p_t = torch.tensor(pars, requires_grad=True)
        tlin.kernel_diag(("SE",), p_t, torch.tensor(t), nugget).sum() \
            .backward()
        np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(g_jax),
                                   rtol=1e-15, atol=0)
    shares = []
    for nugget in (0.5 * tie, tie, 2.0 * tie):
        p_t = torch.tensor(pars, requires_grad=True)
        (tlin.kernel_diag(("SE",), p_t, torch.tensor(t), nugget).sum()
         - 4 * p_t[0] ** 2).backward()
        shares.append(float(p_t.grad[0]))
    assert shares[0] > shares[1] > shares[2] == 0.0
    assert shares[1] == pytest.approx(0.5 * shares[0], rel=1e-12)


def _components(pkg, q, p):
    cf, mf = pkg.covfunc, pkg.meanfunc
    if (q, p) == (1, 3):
        # the last weight holds WhiteNoise, which takes the plain formula
        return ([cf.QuasiPeriodic(1.0, 20.0, 13.0, 0.7)],
                [cf.SquaredExponential(1.0, 10.0),
                 cf.Matern32(1.05, 8.0),
                 cf.SquaredExponential(1.1, 10.0) + cf.WhiteNoise(0.1)],
                [None, mf.Linear(0.01, 0.0), mf.Sine(0.2, 15.0, 0.1)],
                [0.1, 0.12, 0.14])
    return ([cf.Periodic(1.0, 9.0, 0.6), cf.Matern52(1.0, 5.0)],
            [cf.SquaredExponential(1.0 + 0.05 * k, 5.0 + 0.5 * k)
             for k in range(6)],
            [mf.Linear(0.01, 0.0) for _ in range(3)], [0.1, 0.12, 0.14])


N_ENGINE = 48


def _data(p):
    rng = np.random.default_rng(11 + p)
    t = np.sort(rng.uniform(0, 60, N_ENGINE))
    y = np.stack([np.sin(2 * np.pi * t / (9 + 4 * i))
                  + 0.1 * rng.standard_normal(N_ENGINE) for i in range(p)])
    return t, y, np.full((p, N_ENGINE), 0.1 ** 2)


def _f64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module", params=[(1, 3), (2, 3)],
                ids=lambda c: f"q{c[0]}p{c[1]}")
def engines(request):
    """The JAX engine's value and gradient (one compile per model: the
    sweep counts 1 and 3 share a bucket) and the port's engine."""
    q, p = request.param
    nj, wj, mj, jj = _components(gj, q, p)
    nt, wt, mt, _ = _components(gt, q, p)
    eng_j = jg.make_engine(jg.spec_from_components(nj, wj, mj, N_ENGINE))
    eng_t = tg.Engine(tg.spec_from_components(nt, wt, mt, N_ENGINE))
    theta = jg.pack_parameters(nj, wj, mj, jj)
    t, y, yerr2 = _data(p)
    mu0, var0 = (np.asarray(a) for a in eng_j.init_mu_var(theta, y))
    jax_vg = {}
    for n in (1, 3):
        v, g = eng_j.elbo_value_and_grad(theta, t, y, yerr2, mu0, var0, n)
        jax_vg[n] = (float(v), np.asarray(g))
    args = tuple(_f64(a) for a in (theta, t, y, yerr2, mu0, var0))
    return eng_t, args, jax_vg


@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_elbo_fixed_matches_jax(engines, n_sweeps):
    eng_t, args, jax_vg = engines
    v_j = jax_vg[n_sweeps][0]
    v = float(eng_t.elbo_fixed(*args, n_sweeps))
    assert abs(v - v_j) <= 1e-9 * abs(v_j)


@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_elbo_value_and_grad_matches_jax(engines, n_sweeps):
    eng_t, args, jax_vg = engines
    v_j, g_j = jax_vg[n_sweeps]
    v, g = eng_t.elbo_value_and_grad(*args, n_sweeps)
    assert not v.requires_grad and g.dtype == torch.float64
    assert g.shape == args[0].shape
    assert abs(float(v) - v_j) <= 1e-9 * abs(v_j)
    assert np.max(np.abs(g.numpy() - g_j)) <= 1e-8 * np.max(np.abs(g_j))
    assert not args[0].requires_grad       # the caller's theta is untouched


def test_elbo_refine_is_repeated_sweeps(engines):
    eng_t, (theta, t, y, yerr2, mu0, var0), _ = engines
    with pytest.raises(ValueError, match="n_sweeps"):
        eng_t.elbo_fixed(theta, t, y, yerr2, mu0, var0, 0)
    e1, mu1, var1 = eng_t.elbo_refine(theta, t, y, yerr2, mu0, var0, 1)
    e_s, mu_s, var_s = eng_t.sweep_once(theta, t, y, yerr2, mu0, var0)
    assert torch.equal(e1, e_s) and torch.equal(mu1, mu_s) and \
        torch.equal(var1, var_s)
    for _ in range(2):
        e_s, mu_s, var_s = eng_t.sweep_once(theta, t, y, yerr2, mu_s, var_s)
    e3, mu3, var3 = eng_t.elbo_refine(theta, t, y, yerr2, mu0, var0, 3)
    assert torch.equal(e3, e_s) and torch.equal(mu3, mu_s) and \
        torch.equal(var3, var_s)
    assert torch.equal(eng_t.elbo_fixed(theta, t, y, yerr2, mu0, var0, 3),
                       e3)


def test_float32_gradient_is_finite_and_near_float64(engines):
    """The same gradient in float32 on the CPU is finite.  At q=1 it is
    within 1e-3 of max |g| of the float64 one.  At q=2 the float32 jitter
    (4·eps·N·k(0) ≈ 2e-5 here, against the 1e-6 nugget of float64)
    changes the ELBO itself through the cross traces with K⁻¹, so only
    finiteness is held there."""
    eng_t, args, jax_vg = engines
    g64 = jax_vg[3][1]
    v, g = eng_t.elbo_value_and_grad(*(a.float() for a in args), 3)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert bool(torch.isfinite(v))
    if eng_t.spec.q == 1:
        assert np.max(np.abs(g.double().numpy() - g64)) <= \
            1e-3 * np.max(np.abs(g64))
