"""Kernel and mean libraries of gpyrn_tpu_torch against gpyrn_tpu.

The same inputs, made with numpy from a seed, go through the JAX
registry and the port's in float64; every tag, the composites and the
derivative kernels agree to rtol 1e-12 (the formulas keep the JAX
operation order, so only the math libraries' last bits differ)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpyrn_tpu.ops import kernels as jk
from gpyrn_tpu.ops import means as jm
from gpyrn_tpu_torch.ops import kernels as tk
from gpyrn_tpu_torch.ops import means as tm

RTOL = 1e-12

# (structure, core params) for every registry tag
LEAVES = [
    (("C",), (1.3,)),
    (("WN",), (0.4,)),
    (("SE",), (1.2, 8.0)),
    (("P",), (1.1, 9.0, 0.7)),
    (("QP",), (1.1, 20.0, 13.0, 0.6)),
    (("RQ",), (0.9, 1.5, 6.0)),
    (("RQP",), (1.0, 1.2, 15.0, 9.0, 0.8)),
    (("COS",), (1.1, 7.0)),
    (("EXP",), (0.8, 4.0)),
    (("M32",), (1.2, 5.0)),
    (("M52",), (1.2, 5.0)),
    (("LIN",), (0.5,)),
    (("GammaExp",), (1.1, 1.4, 6.0)),
    (("POLY",), (1.0, 0.3, 2.0, 1.7)),
    (("PW",), (12.0,)),
    (("PAC",), (1.1, 3.0, 7.0)),
    (("NP",), (1.0, 1.3, 9.0, 0.9)),
    (("QNP",), (1.0, 1.3, 15.0, 9.0, 0.9)),
    (("NRQP",), (1.0, 1.1, 1.3, 15.0, 9.0, 0.9)),
    (("HP", 3), (3.0, 1.0, 9.0, 0.8)),
    (("QHP", 2), (2.0, 1.0, 15.0, 9.0, 0.8)),
    (("CP",), (1.0, 9.0, 1.5)),
    (("QCP",), (1.0, 15.0, 9.0, 1.5)),
]
COMPOSITES = [
    (("+", ("SE",), ("M32",)), (1.0, 8.0, 0.5, 3.0)),
    (("*", ("QP",), ("C",)), (1.1, 20.0, 13.0, 0.6, 0.8)),
    (("+", ("*", ("P",), ("SE",)), ("RQ",)),
     (1.1, 9.0, 0.7, 1.0, 12.0, 0.9, 1.5, 6.0)),
    (("+", ("SE",), ("LIN",)), (1.0, 8.0, 0.5)),
    (("d", ("SE",)), (1.2, 8.0)),
    (("d", ("P",)), (1.1, 9.0, 0.7)),
    (("d", ("QP",)), (1.1, 20.0, 13.0, 0.6)),
]


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(7)
    t = np.sort(rng.uniform(1.0, 40.0, 24))
    return t[:, None], t[None, :]


def _both(structure, pars, t1, t2):
    r = t1 - t2
    ref = np.asarray(jk.evaluate(structure, jnp.asarray(pars), r=r,
                                 t1=t1, t2=t2))
    got = tk.evaluate(structure, torch.tensor(pars, dtype=torch.float64),
                      r=torch.tensor(r), t1=torch.tensor(t1),
                      t2=torch.tensor(t2))
    return ref, got


@pytest.mark.parametrize("structure,pars", LEAVES + COMPOSITES,
                         ids=lambda v: str(v) if isinstance(v, tuple) and
                         isinstance(v[0], str) else None)
def test_registry_matches_jax(structure, pars, coords):
    ref, got = _both(structure, pars, *coords)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-300)


def test_registry_covers_every_tag():
    assert set(tk._REGISTRY) == set(jk._REGISTRY)
    assert {s[0] for s, _ in LEAVES} == set(jk._REGISTRY)
    for tag, (n, _, nonstat, d2) in jk._REGISTRY.items():
        n_t, _, nonstat_t, d2_t = tk._REGISTRY[tag]
        assert (n_t, nonstat_t, d2_t is None) == (n, nonstat, d2 is None)


@pytest.mark.parametrize("structure,pars", LEAVES + COMPOSITES[:4])
def test_structure_queries_match_jax(structure, pars):
    assert tk.n_params(structure) == jk.n_params(structure) == len(pars)
    assert tk.is_nonstationary(structure) == jk.is_nonstationary(structure)


def _classes(module):
    return {name: getattr(module, name) for name in module.__all__
            if isinstance(getattr(module, name), type)}


def test_object_shell_names_match_jax():
    jax_classes = _classes(jk)
    torch_classes = _classes(tk)
    assert set(torch_classes) == set(jax_classes)
    for name, cls in jax_classes.items():
        assert torch_classes[name]._param_names == cls._param_names, name
        assert torch_classes[name]._tag == cls._tag, name


def test_object_shell_structures_and_parameters():
    kj = (jk.SquaredExponential(1.0, 8.0) * jk.Periodic(1.1, 9.0, 0.7)
          + jk.QuasiHarmonicPeriodic(3, 1.0, 15.0, 9.0, 0.8))
    kt = (tk.SquaredExponential(1.0, 8.0) * tk.Periodic(1.1, 9.0, 0.7)
          + tk.QuasiHarmonicPeriodic(3, 1.0, 15.0, 9.0, 0.8))
    assert kt.structure == kj.structure
    assert kt._param_names == kj._param_names
    np.testing.assert_array_equal(kt.pars, kj.pars)
    np.testing.assert_array_equal(kt.core_params(),
                                  np.asarray(kj.core_params()))
    core = kt.core_params_from(torch.tensor(kt.pars))
    np.testing.assert_array_equal(core.numpy(), np.asarray(
        kj.core_params_from(jnp.asarray(kj.pars))))
    # composites propagate set_parameters into their children
    new = np.arange(1.0, kt.pars.size + 1.5)
    rest_t = kt.set_parameters(new)
    rest_j = kj.set_parameters(new)
    np.testing.assert_array_equal(rest_t, rest_j)
    np.testing.assert_array_equal(kt.k1.k2.pars, kj.k1.k2.pars)
    rebuilt = tk.from_structure(kt.structure, kt.pars)
    assert rebuilt.structure == kt.structure
    np.testing.assert_array_equal(rebuilt.core_params(), kt.core_params())


def test_object_call_evaluates(coords):
    t1, t2 = coords
    r = t1 - t2
    k = tk.Matern52(1.2, 5.0)
    np.testing.assert_allclose(
        k(r).numpy(), np.asarray(jk.Matern52(1.2, 5.0)(r)), rtol=RTOL)
    d = tk.Derivative(tk.SquaredExponential(1.0, 8.0))
    np.testing.assert_allclose(
        d(r).numpy(),
        np.asarray(jk.Derivative(jk.SquaredExponential(1.0, 8.0))(r)),
        rtol=RTOL)
    with pytest.raises(ValueError):
        tk.Derivative(tk.Matern52(1.0, 2.0))


# ---- means -----------------------------------------------------------------

def _multiconst(mod):
    obsid = np.r_[np.ones(8), 2 * np.ones(9), 3 * np.ones(7)]
    time = np.sort(np.random.default_rng(3).uniform(0, 50, obsid.size))
    return mod.MultiConstant([0.3, -0.2, 1.1], obsid, time)


MEANS = {
    "Constant": lambda m: m.Constant(0.7),
    "Linear": lambda m: m.Linear(0.05, -0.3),
    "Parabola": lambda m: m.Parabola(0.01, 0.2, -0.5),
    "Cubic": lambda m: m.Cubic(1e-3, -0.02, 0.2, 1.5),
    "Sine": lambda m: m.Sine(0.8, 11.0, 0.3),
    "MultiConstant": _multiconst,
    "Sum": lambda m: m.Linear(0.05, -0.3) + m.Sine(0.8, 11.0, 0.3),
    "Product": lambda m: m.Constant(0.7) * m.Cubic(1e-3, -0.02, 0.2, 1.5),
}


@pytest.mark.parametrize("name", sorted(MEANS))
@pytest.mark.parametrize("n_t", [24, 31])
def test_means_match_jax(name, n_t):
    mj, mt = MEANS[name](jm), MEANS[name](tm)
    assert mt.structure == mj.structure
    assert mt._param_names == mj._param_names
    np.testing.assert_array_equal(mt.pars, mj.pars)
    # n_t == 24 hits MultiConstant's training-size lookup, 31 its bins
    t = np.sort(np.random.default_rng(n_t).uniform(0, 50, n_t))
    ref = np.asarray(jm.evaluate(mj.structure, jnp.asarray(mj.pars),
                                 jnp.asarray(t)))
    got = tm.evaluate(mt.structure, torch.tensor(mt.pars), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(mt(t).numpy(), ref, rtol=RTOL, atol=1e-300)


def test_mean_set_parameters_chains():
    mt = tm.Linear(0.05, -0.3) + tm.Sine(0.8, 11.0, 0.3)
    mj = jm.Linear(0.05, -0.3) + jm.Sine(0.8, 11.0, 0.3)
    new = np.arange(1.0, 8.0)
    np.testing.assert_array_equal(mt.set_parameters(new),
                                  mj.set_parameters(new))
    np.testing.assert_array_equal(mt.m2.pars, mj.m2.pars)
    with pytest.raises(ValueError):
        mt.set_parameters([1.0])


def test_keplerian_mean_is_not_ported():
    with pytest.raises(NotImplementedError):
        tm.evaluate(("Kep",), torch.ones(5, dtype=torch.float64),
                    torch.zeros(3, dtype=torch.float64))
