"""HMC and NUTS of gpyrn_tpu_torch against gpyrn_tpu.inference.hmc.

The port cannot reproduce ``jax.random``, so the JAX package's draws are
made from its key tree (``chip_smoke_oracle.jax_hmc_draws``) and fed to
the port through ``GivenDraws``; the chains must then be the JAX
package's ``run_hmc`` chains, on a small model (q=1, p=1, N=12, 1 sweep
per ELBO from the heuristic state, log-normal priors of width 0.3):
positions, log-probabilities, acceptance and step size relative 1e-9.

* HMC (sampled in chunks of 2, checkpointed) and NUTS (``max_depth=3``)
  with ``n_warmup=0``;
* HMC through both warmup phases with ``n_warmup=8`` and 2 chains (too
  few draws for a mass estimate: phase 2 runs with identity mass);
* both warmup phases around a diagonal and a dense mass estimate: 26
  chains and ``n_warmup=8`` give phase 1's second half the 52 ≥ 50 draws
  the estimate needs, so each phase adapts over four steps.  Two chains
  would need 104 warmup steps; over that many steps the dual averaging's
  feedback amplifies the float64 rounding differences of the two
  runtimes to 1e-3 of the positions (measured), so such a comparison
  would test the chaos of the adaptation, not the port.

The JAX package compiles every ``run_hmc`` call anew, and under the
tier-1 run's six workers those compilations took minutes, so the JAX
draws and chains of these runs are kept in ``torch_hmc_reference.json``
(written by ``JAX_PLATFORMS=cpu python -m tests.test_torch_hmc``); the
``slow`` test ``test_reference_is_the_jax_packages`` recomputes them
with the JAX package and holds the file to them.

Also: the mass estimate's path, the acceptance guards and a NaN leaf on
a toy target, the fold of nonpositive initial values with its warning,
``HMCResult`` files across packages, ``mcmc(sampler='hmc')`` with
``nwalkers`` → ``n_chains`` and the device draws' reproducibility."""
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

import gpyrn_tpu as gj
from chip_smoke_oracle import jax_hmc_draws
from gpyrn_tpu.inference import hmc as jhmc
from gpyrn_tpu.inference import priors as jpri
from gpyrn_tpu_torch.convert import inference_from_jax
from gpyrn_tpu_torch.inference import hmc as thmc
from gpyrn_tpu_torch.inference import priors as tpri

torch.set_num_threads(1)

RTOL = 1e-9
# the cached JAX results against a fresh JAX computation
REFERENCE_RTOL = 1e-12
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "torch_hmc_reference.json")
SEED = 3
MASS_RUNS = {
    f"hmc_mass_{mass}": dict(algorithm="hmc", n_chains=26, n_warmup=8,
                             n_samples=2, n_leapfrog=2, initial_step=0.01,
                             mass_matrix=mass)
    for mass in ("diag", "dense")}
RUNS = {
    "hmc": dict(algorithm="hmc", n_chains=2, n_warmup=0, n_samples=3,
                n_leapfrog=2, initial_step=0.01, chunk=2),
    "nuts": dict(algorithm="nuts", n_chains=2, n_warmup=0, n_samples=3,
                 max_depth=3, initial_step=0.01),
    "hmc_warmup": dict(algorithm="hmc", n_chains=2, n_warmup=8,
                       n_samples=2, n_leapfrog=2, initial_step=0.01),
    **MASS_RUNS,
}


def _jax_model():
    rng = np.random.default_rng(0)
    N = 12
    t = np.sort(rng.uniform(0, 30, N))
    y = np.sin(2 * np.pi * t / 10) + 0.1 * rng.standard_normal(N)
    g = gj.inference(1, t, y, np.full(N, 0.1))
    g.set_components([gj.covfunc.Periodic(1.0, 10.0, 0.5)],
                     [gj.covfunc.SquaredExponential(1.0, 5.0)], [None],
                     [0.1])
    return g


def _values(g):
    return dict(zip(g.parameters_dict.keys(), g.get_parameters()))


def _settings(g, name):
    return {**RUNS[name], "n_sweeps": 1, "seed": SEED,
            "p0": g.get_parameters()}


def _jax_reference(g, name):
    """The JAX package's run ``name``: its chain and the draws of its key
    tree, as lists."""
    kw = _settings(g, name)
    res = jhmc.run_hmc(g, {n: jpri.LogNormal(np.log(v), 0.3)
                           for n, v in _values(g).items()}, **kw)
    draws = jax_hmc_draws(
        SEED, kw["n_chains"], len(kw["p0"]), kw["n_warmup"],
        kw["n_samples"], chunk=kw.get("chunk", 50),
        mass_matrix=kw.get("mass_matrix", "diag"),
        algorithm=kw["algorithm"], max_depth=kw.get("max_depth", 8))
    return {"chain": res.chain.tolist(), "log_prob": res.log_prob.tolist(),
            "acceptance": float(res.acceptance),
            "step_size": float(res.step_size),
            "parameter_names": list(res.parameter_names),
            "draws": [{k: v.tolist() for k, v in seg.items()}
                      for seg in draws]}


def write_reference():
    g = _jax_model()
    with open(REFERENCE, "w") as f:
        json.dump({name: _jax_reference(g, name) for name in RUNS}, f)
        f.write("\n")


@pytest.fixture(scope="module")
def model():
    g = _jax_model()
    # no fit: every ELBO starts from the heuristic state, in both packages
    return {"g": g, "port": inference_from_jax(g, device="cpu"),
            "p0": g.get_parameters(),
            "priors": {n: tpri.LogNormal(np.log(v), 0.3)
                       for n, v in _values(g).items()}}


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


def _jax_result(ref):
    return jhmc.HMCResult(
        chain=np.array(ref["chain"]), log_prob=np.array(ref["log_prob"]),
        acceptance=ref["acceptance"], step_size=ref["step_size"],
        parameter_names=ref["parameter_names"])


@pytest.fixture(scope="module")
def runs(model, reference, tmp_path_factory):
    """Each run of ``RUNS`` in the port, fed the JAX draws, beside the
    JAX package's result."""
    ckpt = str(tmp_path_factory.mktemp("hmc") / "ckpt.npz")
    out = {"checkpoint": ckpt, "mass_estimates": {}}
    real = thmc._mass_estimate
    for name in RUNS:
        seen = out["mass_estimates"][name] = []

        def spy(zs2, mode, ndim, seen=seen):
            est = real(zs2, mode, ndim)
            seen.append((zs2.shape, est[1] is not None))
            return est

        thmc._mass_estimate = spy
        try:
            got = thmc.run_hmc(model["port"], model["priors"],
                               checkpoint=ckpt if name == "hmc" else None,
                               draws=thmc.GivenDraws(
                                   reference[name]["draws"]),
                               **_settings(model["g"], name))
        finally:
            thmc._mass_estimate = real
        out[name] = (got, _jax_result(reference[name]))
    return out


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b) / np.abs(b)))


def _assert_same_chain(got, ref, kw):
    assert got.chain.shape == (kw["n_samples"], kw["n_chains"], 6)
    assert got.parameter_names == ref.parameter_names
    assert _rel(got.chain, ref.chain) <= RTOL
    assert _rel(got.log_prob, ref.log_prob) <= RTOL
    assert abs(got.acceptance - ref.acceptance) <= RTOL * ref.acceptance
    assert abs(got.step_size - ref.step_size) <= RTOL * ref.step_size
    if kw["n_warmup"] == 0:
        assert got.step_size == kw["initial_step"]
    else:
        assert got.step_size != kw["initial_step"]


@pytest.mark.parametrize("name", list(RUNS))
def test_chain_matches_jax(runs, name):
    """Positions, log-probabilities, acceptance and step size relative
    1e-9 (the step size equal without warmup)."""
    _assert_same_chain(*runs[name], RUNS[name])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RUNS))
def test_reference_is_the_jax_packages(model, reference, name):
    """The cached draws and chains are what the JAX package computes now:
    relative 1e-12, the direction bits equal."""
    fresh = _jax_reference(model["g"], name)
    ref = reference[name]
    for key in ("chain", "log_prob"):
        assert _rel(fresh[key], np.array(ref[key])) <= REFERENCE_RTOL
    assert abs(fresh["acceptance"] - ref["acceptance"]) <= \
        REFERENCE_RTOL * ref["acceptance"]
    assert fresh["step_size"] == pytest.approx(ref["step_size"],
                                               rel=REFERENCE_RTOL)
    assert len(fresh["draws"]) == len(ref["draws"])
    for seg, seg_ref in zip(fresh["draws"], ref["draws"]):
        assert seg.keys() == seg_ref.keys()
        for key in seg:
            a, b = np.array(seg[key]), np.array(seg_ref[key])
            if key == "kd":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=REFERENCE_RTOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_warmup_estimates_the_mass_matrix(runs, name):
    """With 26 chains and 8 warmup steps phase 1 leaves 52 draws, so the
    mass is estimated (a matrix for 'dense', its Cholesky succeeding) and
    phase 2 runs with it; with 2 chains there is no estimate."""
    kw = RUNS[name]
    if name in MASS_RUNS:
        want = [((52, 6), kw["mass_matrix"] == "dense")]
    else:
        want = []
    assert runs["mass_estimates"][name] == want


def _toy_vg(bad):
    """A standard-normal log-density with its gradient; rows where
    ``bad(z)`` holds are NaN."""
    def vg(z):
        v = -0.5 * torch.sum(z * z, dim=-1)
        v = torch.where(bad(z), torch.full_like(v, math.nan), v)
        return v, -z
    return vg


class _Fixed:
    """Given draws of one step: zero momentum, accept uniform 1 - 1e-12,
    every direction forward, every other uniform 0.5."""

    def __init__(self, like):
        self.like = like

    def momentum(self):
        return torch.zeros_like(self.like) + 0.3

    def accept(self):
        return torch.full(self.like.shape[:1], 1 - 1e-12,
                          dtype=self.like.dtype)

    def direction(self, depth):
        return torch.ones(self.like.shape[0], dtype=torch.bool)

    def across(self, depth):
        return torch.full(self.like.shape[:1], 0.5, dtype=self.like.dtype)

    def leaf(self, depth, i):
        return self.across(depth)


def test_acceptance_guards():
    """An invalid current state (log-prob -inf or NaN) accepts any finite
    proposal, even against a uniform of 1 - 1e-12; a NaN proposal is
    rejected with acceptance statistic 0; the same for NUTS, whose chain
    with only NaN leaves keeps its state."""
    z = torch.tensor([[0.5, -0.2], [0.5, -0.2], [0.1, 0.1]],
                     dtype=torch.float64)
    lp = torch.tensor([-math.inf, math.nan, -0.01], dtype=torch.float64)
    one = torch.ones(2, dtype=torch.float64)
    vg = _toy_vg(lambda x: x[:, 0] > 0.2)
    z1, lp1, alpha = thmc._hmc_step(_toy_vg(lambda x: torch.zeros_like(
        x[:, 0], dtype=torch.bool)), 2, _Fixed(z), z, lp, 0.1, one, one)
    assert torch.all(z1[:2] != z[:2]) and torch.all(torch.isfinite(lp1[:2]))
    assert alpha[0] == 1.0 and alpha[1] == 1.0
    # the third chain's proposal is finite but unlikely: rejected
    assert torch.equal(z1[2], z[2]) and lp1[2] == lp[2]
    # a NaN proposal: rejected by the valid chain
    z2, lp2, alpha2 = thmc._hmc_step(_toy_vg(lambda x: torch.ones_like(
        x[:, 0], dtype=torch.bool)), 2, _Fixed(z), z, lp, 0.1, one, one)
    assert torch.equal(z2[2], z[2]) and alpha2[2] == 0.0
    # NUTS: the chains whose leaves are NaN keep their state
    zn, lpn, _ = thmc._nuts_step(vg, 3, _Fixed(z), z, lp, 0.1, one, one)
    assert torch.equal(zn[:2], z[:2])
    assert torch.isneginf(lpn[0]) and torch.isnan(lpn[1])


def test_nan_leaf_adds_nothing_to_the_acceptance_statistic():
    """A NUTS leaf whose log-density is NaN diverges and adds 0 to the
    acceptance statistic (Stan's rule; the JAX package adds NaN, which
    makes its step size NaN under dual averaging): the statistic stays
    finite, the chain keeps its state."""
    z = torch.tensor([[0.5, -0.2], [0.1, 0.1]], dtype=torch.float64)
    lp = -0.5 * torch.sum(z * z, dim=-1)
    one = torch.ones(2, dtype=torch.float64)
    vg = _toy_vg(lambda x: torch.ones_like(x[:, 0], dtype=torch.bool))
    zn, lpn, alpha = thmc._nuts_step(vg, 3, _Fixed(z), z, lp, 0.1, one, one)
    assert torch.equal(alpha, torch.zeros_like(alpha))
    assert torch.equal(zn, z) and torch.equal(lpn, lp)


def test_nonpositive_start_is_folded_with_a_warning(model):
    """p0 with a negative jitter: the chains start at |θ| (default_rng's
    perturbation, as the JAX package draws it) and the warning names the
    parameter."""
    p0 = model["p0"].copy()
    p0[-1] = -p0[-1]
    names = list(model["g"].parameters_dict.keys())
    with pytest.warns(RuntimeWarning, match="jitter"):
        th0 = thmc._initial_positions(list(model["priors"].values()), names,
                                      2, len(names), SEED, p0)
    rng = np.random.default_rng(SEED)
    want = np.abs(np.repeat(p0[None], 2, axis=0)
                  * np.exp(0.01 * rng.standard_normal((2, len(names)))))
    np.testing.assert_array_equal(th0, want)
    with pytest.warns(RuntimeWarning, match="jitter"):
        res = model["port"].mcmc(model["priors"], p0=p0, sampler="hmc",
                                 niter=1, n_warmup=0, n_chains=2,
                                 n_leapfrog=1, n_sweeps=1)
    assert np.all(res.chain > 0) and np.all(np.isfinite(res.log_prob))


def test_result_files_load_in_either_package(model, runs, tmp_path):
    got, ref = runs["hmc"]
    for save, load in ((got.save, jhmc.HMCResult.load),
                       (ref.save, thmc.HMCResult.load)):
        path = tmp_path / "chain"
        save(str(path))                      # savez appends .npz
        back = load(str(path))
        src = got if save == got.save else ref
        np.testing.assert_array_equal(back.chain, src.chain)
        np.testing.assert_array_equal(back.log_prob, src.log_prob)
        assert back.acceptance == src.acceptance
        assert back.step_size == src.step_size
        assert list(back.parameter_names) == list(src.parameter_names)
        assert np.array_equal(back.get_chain(flat=True),
                              src.get_chain(flat=True))


def test_checkpoint_after_each_chunk(runs):
    """The HMC run samples in chunks of 2 (the JAX key tree splits per
    chunk) and leaves its whole chain in the checkpoint file."""
    got, _ = runs["hmc"]
    back = thmc.HMCResult.load(runs["checkpoint"])
    np.testing.assert_array_equal(back.chain, got.chain)
    np.testing.assert_array_equal(back.log_prob, got.log_prob)


def test_mcmc_hmc_sets_chains_from_nwalkers(model):
    """``mcmc(sampler='hmc')`` runs ``run_hmc``: ``niter`` samples,
    ``nwalkers`` chains (an explicit ``n_chains`` wins); the device draws
    repeat with the seed and change with it."""
    port, priors = model["port"], model["priors"]
    kw = dict(p0=model["p0"], sampler="hmc", niter=2, n_warmup=0,
              n_leapfrog=1, n_sweeps=1)
    a = port.mcmc(priors, nwalkers=3, seed=1, **kw)
    b = port.mcmc(priors, nwalkers=3, seed=1, **kw)
    c = port.mcmc(priors, nwalkers=3, n_chains=2, seed=2, **kw)
    assert isinstance(a, thmc.HMCResult)
    assert a.chain.shape == (2, 3, 6) and c.chain.shape == (2, 2, 6)
    np.testing.assert_array_equal(a.chain, b.chain)
    assert not np.array_equal(a.chain[:, :2], c.chain)
    assert 0 <= a.acceptance <= 1 and np.all(np.isfinite(a.log_prob))
    with pytest.raises(ValueError, match="unknown algorithm"):
        port.mcmc(priors, algorithm="mala", **kw)
    with pytest.raises(ValueError, match="missing priors"):
        thmc.run_hmc(port, {"node1.theta": priors["node1.theta"]})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(thmc.DeviceDraws(0).segment(
            2, torch.zeros(3, 6, dtype=torch.float64))) == 2


if __name__ == "__main__":
    write_reference()
