"""``ELBOcalc(precision='mixed')`` of gpyrn_tpu_torch against gpyrn_tpu.

One JAX inference (q=1, p=2, N=40: QuasiPeriodic node, SE weights) is
carried into the port on the CPU with ``inference_from_jax``, fit
settings included, and both run the same mode: each of the four float32
bulk fits (the merit-stall fit, the plain state rule, the reference ELBO
rule, the Anderson-accelerated fit) with three float64 polish sweeps and
with ``refine_sweeps='converge'``.

Tolerances.  The float32 bulk is not comparable between runtimes
mid-ascent, so the modes are held to the JAX package only through the
float64 ELBO the polish returns:

* three polish sweeps: relative ``POLISH3_RTOL`` = 2e-4, what the JAX
  package's own ``tests/test_fit_stall.py`` allows between two float32
  bulk fits after the same polish (the accelerated fit, which stops its
  two runs at different blocks, gets ``ACCEL_RTOL`` = 1e-3, the
  allowance of ``tests/test_mixed_precision.py::test_mixed_multi_output``
  between a mixed fit and the float64 fixed point);
* ``'converge'``: relative 1e-7, the allowance of
  ``test_mixed_refine_converge_lands_on_fixed_point``: both land on the
  same float64 fixed point.

The float64 parts are held tightly: the Anderson polish from one common
float64 state gives the same ELBO (1e-9), state (1e-8) and sweep count
in both packages, and ``n_iter`` is always bulk sweeps + polish sweeps."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference import meanfield as tm

# matrices of N <= 64 gain nothing from threads, and eight of them spinning
# beside the other test workers cost a factor of tens
torch.set_num_threads(1)

POLISH3_RTOL = 2e-4
ACCEL_RTOL = 1e-3
CONVERGE_RTOL = 1e-7
N = 40

MODES = {
    "stall": {},
    "state": {"mixed_stall": False, "mixed_tol": 1e-3},
    "elbo": {"mixed_stop": "elbo"},
    "accelerate": {"fit_accelerate": True},
}


def _jax_model(**settings):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, N))
    data = []
    for i in range(2):
        data += [np.sin(2 * np.pi * t / (20 + 5 * i))
                 + 0.1 * rng.standard_normal(N), np.full(N, 0.1)]
    g = gj.inference(1, t, *data)
    g.set_components([gj.covfunc.QuasiPeriodic(1.0, 30.0, 20.0, 0.7)],
                     [gj.covfunc.SquaredExponential(1.0 + 0.05 * k, 30.0)
                      for k in range(2)], [None] * 2, [0.1] * 2)
    for key, value in settings.items():
        setattr(g, key, value)
    return g


@pytest.fixture(scope="module")
def runs():
    """Every (bulk mode, polish) once in each package."""
    out = {}
    for mode, settings in MODES.items():
        for refine in (3, "converge"):
            g = _jax_model(refine_sweeps=refine, **settings)
            port = inference_from_jax(g, device="cpu")
            ref = g.ELBOcalc(precision='mixed')
            got = port.ELBOcalc(precision='mixed')
            out[mode, refine] = (g, port, ref, got)
    return out


def test_settings_travel_with_the_model():
    g = _jax_model(refine_sweeps='converge', refine_tol=1e-9,
                   refine_max_sweeps=50, mixed_tol=1e-3, mixed_stall=False,
                   stall_block=4, stall_tol=1e-3, stall_patience=2,
                   mixed_stop='elbo', fit_accelerate=True, accel_sweeps=3,
                   accel_tol=1e-3, accel_patience=2, update_muvar_after=7,
                   elbo_max_iter=11)
    port = inference_from_jax(g, device="cpu")
    for name in ("refine_sweeps", "refine_tol", "refine_max_sweeps",
                 "mixed_tol", "mixed_stall", "stall_block", "stall_tol",
                 "stall_patience", "mixed_stop", "fit_accelerate",
                 "accel_sweeps", "accel_tol", "accel_patience",
                 "update_muvar_after", "elbo_max_iter"):
        assert getattr(port, name) == getattr(g, name), name
    np.testing.assert_array_equal(port.tt, g.tt)


def test_defaults_match_jax():
    g = _jax_model()
    fresh = inference_from_jax(g, device="cpu")
    from gpyrn_tpu.inference import meanfield as jm
    assert tm.STALL_MIN_TOL == jm.STALL_MIN_TOL == 1e-5
    assert (fresh.refine_sweeps, fresh.refine_tol, fresh.refine_max_sweeps,
            fresh.mixed_tol, fresh.mixed_stall, fresh.stall_block,
            fresh.stall_tol, fresh.stall_patience, fresh.mixed_stop,
            fresh.fit_accelerate, fresh.accel_sweeps, fresh.accel_tol,
            fresh.accel_patience, fresh.update_muvar_after,
            fresh.elbo_max_iter) == (3, 1e-8, 80, 1e-4, True, 8, 1e-4, 3,
                                     'state', False, 5, 2e-4, 5, 50, 5000)


@pytest.mark.parametrize("refine", [3, "converge"])
@pytest.mark.parametrize("mode", MODES)
def test_mixed_matches_jax(runs, mode, refine):
    g, port, (e_j, mu_j, var_j, it_j), (elbo, mu, var, n_iter) = \
        runs[mode, refine]
    rtol = CONVERGE_RTOL if refine == "converge" else \
        ACCEL_RTOL if mode == "accelerate" else POLISH3_RTOL
    assert isinstance(elbo, float) and np.isfinite(elbo)
    assert abs(elbo - e_j) <= rtol * abs(e_j), (elbo, e_j)
    assert mu.dtype == var.dtype == torch.float64
    assert mu.shape == var.shape == (port.d,)
    info = port.mixed_info
    assert info["bulk"] == mode
    assert n_iter == info["bulk_sweeps"] + info["polish_sweeps"]
    if refine == 3:
        assert info["polish_sweeps"] == 3
    else:
        assert 2 <= info["polish_sweeps"] <= port.refine_max_sweeps + 1
    assert port.elbo_history.shape == (1,)
    assert float(port.elbo_history[0]) == elbo
    # both fits converged, so both cached their state
    assert port._mu is mu and port._var is var and g._mu is not None
    if mode == "stall":
        assert info["stalled"] or info["blocks"] * 8 == info["bulk_sweeps"]
        assert info["nonfinite_merits"] == 0
        assert info["bulk_sweeps"] % port.stall_block == 0
    if mode == "elbo" and refine == 3:
        # the reference rule reads the same three ELBO values to 1e-3 in
        # both runtimes: the same few float32 sweeps, give or take one
        # where a float32 value sits on the rule's threshold
        assert abs(n_iter - it_j) <= 1


def test_mixed_elbo_at_least_reference_rule(runs):
    """As ``tests/test_mixed_precision.py`` asks of the JAX package."""
    _, port, _, (elbo, *_rest) = runs["stall", 3]
    e_ref, *_ = port.ELBOcalc()
    assert elbo >= e_ref - 1e-6


def test_converged_polish_from_a_common_state_matches_jax(runs):
    """The float64 Anderson polish, from one float64 state: the same
    ELBO, state and count of sweeps."""
    g, port, _, _ = runs["stall", 3]
    theta = g._theta()
    t = np.asarray(g.time, dtype=float)
    mu0, var0 = (np.asarray(a, dtype=float)
                 for a in g.engine.init_mu_var(theta, g.y))

    def sweep_jax(m, v):
        e, m2, v2 = g.engine.elbo_refine(theta, t, g.y, g.yerr2, m, v, 1)
        return float(e), np.asarray(m2), np.asarray(v2)

    def sweep_port(m, v):
        e, m2, v2 = port.engine.elbo_refine(
            port._theta(), *port._data(), port._tensor(m), port._tensor(v),
            1)
        return float(e), m2.numpy(), v2.numpy()

    e_j, mu_j, var_j, n_j = g._converged_refine(sweep_jax, mu0, var0)
    e_t, mu_t, var_t, n_t = port._converged_refine(sweep_port, mu0, var0)
    assert n_t == n_j
    assert abs(e_t - e_j) <= 1e-9 * abs(e_j)
    for a, b in ((mu_t, mu_j), (var_t, var_j)):
        assert np.max(np.abs(a - b)) <= 1e-8 * (1 + np.max(np.abs(b)))


def test_cache_rule_and_previous_start(capsys):
    """An unconverged mixed fit is not cached; a converged one is, in
    float64, and serves as the 'previous' start of the next (cast to
    float32 for the bulk)."""
    port = inference_from_jax(_jax_model(mixed_stall=False, mixed_tol=1e-7),
                              device="cpu")
    elbo, mu, var, n_iter = port.ELBOcalc(precision='mixed', max_iter=8)
    assert port._mu is None and n_iter == 8 + 3
    assert "Max iterations reached" in capsys.readouterr().out
    port.mixed_tol, port.mixed_stall = 1e-4, True
    e1, mu1, _, it1 = port.ELBOcalc(precision='mixed')
    assert port._mu is mu1 and mu1.dtype == torch.float64
    e2, _, _, it2 = port.ELBOcalc(precision='mixed', mu='previous',
                                  var='previous')
    assert it2 <= it1 and abs(e2 - e1) <= POLISH3_RTOL * abs(e1)
    e3, *_ = port.ELBOcalc(precision='mixed', mu=mu1.numpy(),
                           var=port._var.numpy())
    assert e3 == e2 or abs(e3 - e1) <= POLISH3_RTOL * abs(e1)


def test_tight_mixed_tol_disarms_the_stall():
    """``mixed_tol`` below ``STALL_MIN_TOL`` runs the plain state rule,
    identical to ``mixed_stall=False``; the default tolerance arms the
    stall, which stops well under the budget."""
    a = inference_from_jax(_jax_model(mixed_tol=1e-8), device="cpu")
    e_a, _, _, it_a = a.ELBOcalc(precision='mixed', max_iter=200)
    b = inference_from_jax(_jax_model(mixed_tol=1e-8, mixed_stall=False),
                           device="cpu")
    e_b, _, _, it_b = b.ELBOcalc(precision='mixed', max_iter=200)
    assert a.mixed_info["bulk"] == b.mixed_info["bulk"] == "state"
    assert (it_a, e_a) == (it_b, e_b)
    c = inference_from_jax(_jax_model(), device="cpu")
    _, _, _, it_c = c.ELBOcalc(precision='mixed', max_iter=200)
    assert c.mixed_info["bulk"] == "stall" and it_c < it_a


@pytest.mark.parametrize("setting,item", [
    ({"fit_method": "cg"}, "A12"), ({"fit_method": "svi"}, "A12"),
    ({"refine_method": "df64"}, "A13")])
def test_unported_modes_raise_with_their_roadmap_item(setting, item):
    port = inference_from_jax(_jax_model(**setting), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        port.ELBOcalc(precision='mixed')
    # the float64 fit ignores these settings, as in the JAX package
    assert np.isfinite(port.ELBOcalc(max_iter=4)[0])


def test_bad_settings_raise():
    port = inference_from_jax(_jax_model(refine_method="bogus"),
                              device="cpu")
    with pytest.raises(ValueError, match="refine_method"):
        port.ELBOcalc(precision='mixed')
    with pytest.raises(ValueError, match="precision"):
        port.ELBOcalc(precision='float32')
    # 'f64' is native float64, the same as 'auto'
    port.refine_method = 'f64'
    assert np.isfinite(port.ELBOcalc(precision='mixed')[0])
