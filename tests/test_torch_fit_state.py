"""The converged-state fits of the gpyrn_tpu_torch engine against gpyrn_tpu.

``Engine.fit_state`` and ``Engine.fit_state_stall`` for (q, p) = (1, 3)
and (2, 3) at N=40, in float64 (float32 trajectories are not comparable
mid-ascent), on parameters, data and a starting state made with numpy
from a seed.  The same map runs in both packages, so the sweep counts
and the ``converged`` flags are equal and the states agree within
1e-8·(1 + max |state|): at a loose and a tight tolerance and at a
``max_iter`` that cuts the fit.  The stall fit runs ``fit_state``'s
update map, returns the best block's state on a stall and the current one
on the state rule, keeps its ``max_iter`` budget in whole blocks, and
treats a non-finite merit as the JAX loop does (never an improvement;
the current state when no merit was ever finite)."""
import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from gpyrn_tpu.models import gprn as jg
import gpyrn_tpu_torch as gt
from gpyrn_tpu_torch.models import gprn as tg

# matrices of N <= 64 gain nothing from threads, and eight of them spinning
# beside the other test workers cost a factor of tens
torch.set_num_threads(1)

STATE_TOL = 1e-8
N = 40


def _components(pkg, q):
    cf, mf = pkg.covfunc, pkg.meanfunc
    if q == 1:
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
            # jitters at which the q = 2 map converges in hundreds of
            # sweeps, not thousands
            [mf.Linear(0.01, 0.0) for _ in range(3)], [0.3, 0.32, 0.34])


def _data():
    rng = np.random.default_rng(14)
    t = np.sort(rng.uniform(0, 60, N))
    y = np.stack([np.sin(2 * np.pi * t / (9 + 4 * i))
                  + 0.1 * rng.standard_normal(N) for i in range(3)])
    return t, y, np.full((3, N), 0.1 ** 2)


def _f64(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b)))


@pytest.fixture(scope="module", params=[1, 2], ids=["q1p3", "q2p3"])
def both(request):
    """Both engines on one configuration, with their common arguments."""
    q = request.param
    nj, wj, mj, jj = _components(gj, q)
    nt, wt, mt, _ = _components(gt, q)
    eng_j = jg.make_engine(jg.spec_from_components(nj, wj, mj, N))
    eng_t = tg.Engine(tg.spec_from_components(nt, wt, mt, N))
    theta = jg.pack_parameters(nj, wj, mj, jj)
    t, y, yerr2 = _data()
    mu0, var0 = (np.asarray(a) for a in eng_j.init_mu_var(theta, y))
    args_j = (theta, t, y, yerr2, mu0, var0)
    args_t = tuple(_f64(a) for a in args_j)
    return eng_j, eng_t, args_j, args_t


FIT_STATE_CASES = {"loose": (3000, 1e-3), "tight": (3000, 1e-6),
                   "max_iter": (7, 0.0)}


@pytest.mark.parametrize("case", FIT_STATE_CASES)
def test_fit_state_matches_jax(both, case):
    eng_j, eng_t, args_j, args_t = both
    max_iter, tol = FIT_STATE_CASES[case]
    mu_j, var_j, it_j, conv_j = eng_j.fit_state(*args_j, max_iter, tol)
    mu, var, n_iter, converged = eng_t.fit_state(*args_t, max_iter, tol)
    assert isinstance(n_iter, int) and isinstance(converged, bool)
    assert (n_iter, converged) == (int(it_j), bool(conv_j))
    assert converged == (case != "max_iter")
    if case == "max_iter":
        assert n_iter == max_iter
    assert mu.dtype == torch.float64
    assert _err(mu.numpy(), mu_j) <= STATE_TOL
    assert _err(var.numpy(), var_j) <= STATE_TOL


def test_fit_state_keeps_the_tensors_dtype(both):
    _, eng_t, _, args_t = both
    mu, var, n_iter, _ = eng_t.fit_state(
        *(a.to(torch.float32) for a in args_t), 3, 0.0)
    assert mu.dtype == var.dtype == torch.float32 and n_iter == 3
    assert bool(torch.isfinite(mu).all()) and bool((var > 0).all())


# (max_iter, tol, block, stall_tol, patience)
STALL_CASES = {
    # no rule can fire: two blocks of the plain map
    "same-map": (16, 0.0, 8, 0.0, 10_000),
    # every block after the first fails to improve: the best (first)
    # block's state comes back
    "best-block": (400, 1e-14, 8, np.inf, 1),
    # the state rule fires first: the current state comes back
    "state-rule": (2000, 1e-4, 4, 0.0, 10_000),
    # the merit stalls at its resolution before the state rule
    "stall": (2000, 1e-12, 8, 1e-7, 2),
    # the budget in whole blocks: 5 blocks of 8 pass 36
    "budget": (36, 0.0, 8, 0.0, 10_000),
}


@pytest.mark.parametrize("case", STALL_CASES)
def test_fit_state_stall_matches_jax(both, case):
    eng_j, eng_t, args_j, args_t = both
    max_iter, tol, block, stall_tol, patience = STALL_CASES[case]
    mu_j, var_j, it_j, conv_j = eng_j.fit_state_stall(
        *args_j, max_iter, tol, block, stall_tol, patience)
    info = {}
    mu, var, n_iter, converged = eng_t.fit_state_stall(
        *args_t, max_iter, tol, block, stall_tol, patience, info)
    assert (n_iter, converged) == (int(it_j), bool(conv_j))
    assert _err(mu.numpy(), mu_j) <= STATE_TOL
    assert _err(var.numpy(), var_j) <= STATE_TOL
    assert info["blocks"] * block == n_iter
    assert info["nonfinite_merits"] == 0 and np.isfinite(info["best_merit"])
    if case in ("same-map", "best-block"):
        assert n_iter == 16 and converged == (case == "best-block")
        # the budget exit too returns the best block's state: the second
        # block's (16 plain sweeps) where the merit rose, as it always
        # does for q = 1; for q > 1 the ELBO's quirks can make it fall
        q = eng_t.spec.q
        errs = []
        for sweeps in (8, 16):
            mu_p, var_p, _, _ = eng_t.fit_state(*args_t, sweeps, 0.0)
            errs.append(max(_err(mu.numpy(), mu_p.numpy()),
                            _err(var.numpy(), var_p.numpy())))
        if case == "best-block":
            assert errs[0] <= 1e-11
        elif q == 1:
            assert errs[1] <= 1e-11
        else:
            assert min(errs) <= 1e-11
    if case == "state-rule":
        assert converged and not info["stalled"] and n_iter < max_iter
        # the current state: one more plain sweep moves it by less than tol
        mu_n, _, _, _ = eng_t.fit_state(*args_t[:4], mu, var, 1, 0.0)
        assert _err(mu_n.numpy(), mu.numpy()) < tol
    if case == "stall":
        assert converged and info["stalled"] and n_iter < max_iter
    if case == "budget":
        assert (n_iter, converged) == (40, False)


def test_nonfinite_merit_takes_the_jax_branch(both, monkeypatch):
    """A NaN merit never improves (``isfinite(e) & (e > thresh)``), so the
    stall counter runs up to ``patience``; with no finite merit ever, the
    current state is returned, not the (initial) best one."""
    _, eng_t, _, args_t = both
    real_sweep = eng_t._sweep
    calls = []

    def nan_sweep(*a):
        e, *state = real_sweep(*a)
        calls.append(float(e))
        return (e * float("nan"), *state)

    monkeypatch.setattr(eng_t, "_sweep", nan_sweep)
    info = {}
    mu, var, n_iter, converged = eng_t.fit_state_stall(
        *args_t, 400, 0.0, 4, 1e-4, 3, info)
    assert (n_iter, converged) == (12, True) and len(calls) == 3
    assert info["nonfinite_merits"] == 3 and info["stalled"]
    assert info["best_merit"] == -np.inf
    mu_p, var_p, _, _ = eng_t.fit_state(*args_t, 12, 0.0)
    assert _err(mu.numpy(), mu_p.numpy()) <= 1e-11

    # NaN in the second block only: the first block stays the best, the
    # NaN block counts as one that failed to improve
    calls.clear()

    def second_nan(*a):
        e, *state = real_sweep(*a)
        calls.append(float(e))
        return (e * float("nan") if len(calls) == 2 else e, *state)

    monkeypatch.setattr(eng_t, "_sweep", second_nan)
    info = {}
    mu, var, n_iter, converged = eng_t.fit_state_stall(
        *args_t, 400, 0.0, 4, np.inf, 2, info)
    assert (n_iter, converged) == (12, True)
    assert info["nonfinite_merits"] == 1
    assert info["best_merit"] == calls[0]
    mu_p, _, _, _ = eng_t.fit_state(*args_t, 4, 0.0)
    assert _err(mu.numpy(), mu_p.numpy()) <= 1e-11
